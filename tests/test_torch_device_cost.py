"""The program ledger's cost figures in the port (``observability/device.py``:
``stage_cost``, ``lowered_cost``, ``compiled_memory``) against the analytic
matmul count and the JAX package's ledger, on the CPU.

A tiny LM (vocab 17, d_model 32, 2 layers, 4 heads, the JAX engine tests'
size) carried across from JAX: the ``generate_serve`` program's ``flops``
and one dense engine chunk's ``flops`` equal the analytic count of the
matmuls a call of the program runs (the prefill and the bucket's
``bucket_new - 1`` decode steps; the chunk's ``admit_every`` steps), exactly;
``bytes_accessed`` is None and ``memory`` is None on the CPU; the tokens
are those of runs the ledger did not count; JAX's ledger holds the same
entries, with ``flops`` set.  Both packages' process-wide ledgers and
serve caches are emptied for each test and put back as they were.

Run as a script, it prints JAX's and the port's ``flops`` for one tiny
serve program and their ratio (XLA also counts elementwise and
transcendental work).
"""

import contextlib

import jax
import numpy as np
import pytest
import torch

from test_torch_engine import HEADS, T_MAX, _engines, _prompts, _setup
from test_torch_engine import jax_program_ledgers_restored
from znicz_tpu.observability import device as jdevice
from znicz_tpu.workflow import generate as JG
from znicz_tpu_torch.observability import device as tdevice
from znicz_tpu_torch.workflow import generate as G

torch.set_float32_matmul_precision("highest")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

VOCAB, D, LAYERS, FFN = 17, 32, 2, 128


@contextlib.contextmanager
def serve_caches_emptied():
    """Both packages' serve caches empty inside the block (every program a
    first make), and as they were afterwards."""
    saved = (dict(JG._serve_cache.programs), dict(G._serve_cache.programs))
    JG._serve_cache.programs.clear()
    G._serve_cache.programs.clear()
    try:
        yield
    finally:
        for cache, programs in zip((JG._serve_cache, G._serve_cache), saved):
            cache.programs.clear()
            cache.programs.update(programs)


@contextlib.contextmanager
def device_ledgers_emptied():
    """Both packages' device ledgers empty inside the block (a key an
    earlier test ledgered would otherwise be overwritten in place, not
    added), and as they were afterwards."""
    saved = []
    for ledger in (jdevice, tdevice):
        with ledger._LOCK:
            saved.append(dict(ledger._PROGRAMS))
            ledger._PROGRAMS.clear()
    try:
        yield
    finally:
        for ledger, programs in zip((jdevice, tdevice), saved):
            with ledger._LOCK:
                ledger._PROGRAMS.clear()
                ledger._PROGRAMS.update(programs)


@pytest.fixture(autouse=True)
def _fresh_ledgers():
    with jax_program_ledgers_restored(), serve_caches_emptied(), device_ledgers_emptied():
        yield


def _block_flops(rows, tq, keys):
    """One pre-LN block's matmuls for ``rows`` x ``tq`` queries over
    ``keys`` cached positions: q, k, v and the output projection, the
    scores and the weighted values, the two FFN layers."""
    return rows * tq * (4 * 2 * D * D + 2 * 2 * keys * D + 2 * 2 * D * FFN)


def _tower_flops(rows, tq, keys):
    """The blocks and the head's logits at one position a row."""
    return LAYERS * _block_flops(rows, tq, keys) + rows * 2 * D * VOCAB


def _entries(ledger, source):
    return {e["key"]: e for e in ledger.programs(source)}


def test_serve_program_flops_are_the_analytic_count_and_tokens_unchanged():
    jp, tp = _setup()
    prompt = np.stack(_prompts(5, (7, 7, 7)))  # B 3, bucket 16
    kw = dict(n_heads=HEADS, max_new_tokens=6)
    plain = G.generate(tp, prompt, **kw).numpy()  # no ledger, no cost
    assert tdevice.programs() == []
    first = G.generate_serve(tp, prompt, **kw).numpy()
    (entry,) = _entries(tdevice, "serve_cache").values()
    bucket_tp, bucket_new, b = 16, 16, 3
    keys = bucket_tp + bucket_new
    want = _tower_flops(b, bucket_tp, keys) + (bucket_new - 1) * _tower_flops(b, 1, keys)
    assert entry["flops"] == float(want)
    assert entry["bytes_accessed"] is None and entry["memory"] is None
    again = G.generate_serve(tp, prompt, **kw).numpy()  # a hit: counted nothing
    np.testing.assert_array_equal(first, plain)
    np.testing.assert_array_equal(again, plain)
    assert [e["key"] for e in tdevice.programs("serve_cache")].count(entry["key"]) == 1
    jtok = np.asarray(JG.generate_serve(jp, prompt, **kw))
    np.testing.assert_array_equal(plain, jtok)
    jnew = _entries(jdevice, "serve_cache")
    assert set(jnew) == {entry["key"]}
    assert jnew[entry["key"]]["flops"] > 0


def test_engine_chunk_flops_are_the_analytic_count():
    jp, tp = _setup()
    reqs = list(zip(_prompts(7, (5, 20)), (9, 7)))  # buckets 16 and 32
    je, te = _engines(jp, tp)  # batch 2, admit_every 4, max_seq T_MAX
    for eng in (je, te):
        for prompt, budget in reqs:
            eng.submit(prompt, budget)
    jdone, tdone = je.run(), te.run()
    for jc, tc in zip(jdone, tdone):
        np.testing.assert_array_equal(tc.tokens, jc.tokens)
    tnew = _entries(tdevice, "engine")
    jnew = _entries(jdevice, "engine")
    assert set(tnew) == set(jnew) and len(tnew) == 3
    assert all(e["flops"] > 0 for e in list(tnew.values()) + list(jnew.values()))
    assert all(e["bytes_accessed"] is None and e["memory"] is None for e in tnew.values())
    by_kind = {e["kind"]: [] for e in tnew.values()}
    for e in tnew.values():
        by_kind[e["kind"]].append(e)
    (chunk,) = by_kind["chunk"]
    assert chunk["flops"] == float(4 * _tower_flops(2, 1, T_MAX))
    # an admission prefills one [1, bucket] prompt over its own row's cache
    for admit in by_kind["admit"]:
        bucket = int(admit["key"].split(",")[1])
        assert admit["flops"] == float(_tower_flops(1, bucket, T_MAX))


def test_engine_counting_leaves_the_tokens_alone():
    """The same stream on a fresh engine of the same geometry (its
    programs already ledgered process-wide, so nothing is counted) gives
    the counted engine's tokens."""
    jp, tp = _setup()
    reqs = list(zip(_prompts(9, (4, 10, 6)), (8, 5, 6)))
    outs = []
    for _ in range(2):
        _, te = _engines(jp, tp)
        for prompt, budget in reqs:
            te.submit(prompt, budget)
        outs.append([c.tokens for c in te.run()])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_cost_helpers_never_raise():
    class Boom:
        def get_total_flops(self):
            raise RuntimeError("no counter")

        def pool(self):
            raise RuntimeError("no pool")

    assert tdevice.stage_cost(None) is None
    assert tdevice.stage_cost(Boom()) is None
    assert tdevice.compiled_memory(None) is None
    assert tdevice.compiled_memory(Boom()) is None
    out, cost = tdevice.lowered_cost(lambda a, b: a @ b, (torch.ones(2, 3), torch.ones(3, 4)))
    assert out.shape == (2, 4) and cost == {"flops": 48.0, "bytes_accessed": None}


def _ratio():
    """JAX's flops over the port's for one tiny serve program."""
    jp, tp = _setup()
    prompt = np.stack(_prompts(5, (7,)))
    kw = dict(n_heads=HEADS, max_new_tokens=6)
    with jax_program_ledgers_restored(), serve_caches_emptied(), device_ledgers_emptied():
        G.generate_serve(tp, prompt, **kw)
        JG.generate_serve(jp, prompt, **kw)
        port = tdevice.programs("serve_cache")[-1]
        ref = jdevice.programs("serve_cache")[-1]
    return ref["key"], ref["flops"], port["flops"]


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    key, jax_flops, port_flops = _ratio()
    print(f"program {key}: JAX {jax_flops} flops, port {port_flops} flops, "
          f"JAX/port {jax_flops / port_flops}")
