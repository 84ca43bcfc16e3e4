"""The port's serving engines on their own terms; their CUDA-graph programs
on the card.  This file imports no jax, so it runs on the card with
``python3 -m pytest --noconftest -p no:cacheprovider
tests/test_torch_engine_cuda.py -q``.

On the CPU: each engine's completions equal the port's single-request
``generate()`` trimmed at EOS (dense, paged, speculative), and an engine
holds no graph there.  On the card (``cuda``-marked, skipped without one):
the replayed programs give the tokens of the same engine run eagerly
(``cuda_graphs=False``) on the same stream (greedy, sampled from one
``torch.Generator`` state, MoE capacity routing, paged with the prefix
cache, speculative), one graph per program key; a second stream on the
engine captures nothing; and a replayed chunk, its inputs' copies
included, makes no host sync (``torch.cuda.set_sync_debug_mode("error")``).
"""

import numpy as np
import pytest
import torch

from znicz_tpu_torch.core import prng
from znicz_tpu_torch.services.engine import DecodeEngine, PagedDecodeEngine
from znicz_tpu_torch.workflow import generate as G
from znicz_tpu_torch.workflow.transformer import init_lm_params

torch.set_float32_matmul_precision("highest")
torch.backends.cuda.matmul.allow_tf32 = False

HEADS = 4
EOS = 14
KINDS = {"dense": ("admit", "chunk"), "paged": ("prefill", "paged_chunk", "cow", "spec_verify")}


def _params(device, moe_experts=0, seed=27, max_seq=64):
    prng.reset()
    prng.seed_all(seed)
    params = init_lm_params(17, 32, 2, HEADS, max_seq, moe_experts=moe_experts, device=device)
    prng.reset()
    return params


def _stream(seed=7, lengths=(5, 12, 3, 20, 9, 30, 6), budgets=(6, 9, 12, 7, 8, 4, 10)):
    gen = np.random.default_rng(seed)
    return [(gen.integers(0, 17, (n,)).astype(np.int32), b) for n, b in zip(lengths, budgets)]


def _make(params, backend, **kw):
    kw = {**dict(n_heads=HEADS, eos_id=EOS, batch_size=3, admit_every=4), **kw}
    if backend == "dense":
        return DecodeEngine(params, **kw)
    return PagedDecodeEngine(params, **{**dict(block_size=8, max_seq=64), **kw})


def _serve(eng, reqs):
    ids = [eng.submit(p, b) for p, b in reqs]
    eng.run()
    return [eng.completions[i].tokens for i in ids]


def _reference(params, prompt, budget, **moe):
    out = G.generate(params, np.asarray(prompt)[None], n_heads=HEADS, max_new_tokens=budget,
                     eos_id=EOS, **moe).cpu().numpy()[0]
    new = out[len(prompt):]
    hit = np.where(new == EOS)[0]
    return np.concatenate([prompt, new[: hit[0] + 1] if len(hit) else new])


@pytest.mark.parametrize("backend,kw", [
    ("dense", {}), ("paged", {}), ("paged", dict(spec_k=3, drafter=G.PromptLookupDrafter(3, 1))),
], ids=["dense", "paged", "spec"])
def test_engine_equals_generate_on_the_cpu(backend, kw):
    params = _params("cpu")
    reqs = _stream()
    eng = _make(params, backend, **kw)
    for (prompt, budget), got in zip(reqs, _serve(eng, reqs)):
        np.testing.assert_array_equal(got, _reference(params, prompt, budget))
    st = eng.compile_stats()
    assert all(v == 0 for k, v in st.items() if k.endswith("_graph_entries"))
    assert set(eng.capture_s) == set(st["programs"])


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


CASES = [
    ("dense", 0, {}),
    ("dense", 0, dict(temperature=0.9, top_k=5, top_p=0.9)),
    ("dense", 4, dict(moe_top_k=2, moe_dispatch="capacity")),
    ("paged", 0, dict(prefix_cache=True)),
    ("paged", 0, dict(temperature=0.8, n_blocks=9)),
    ("paged", 4, dict(moe_top_k=2, moe_dispatch="capacity")),
    ("paged", 0, dict(spec_k=3)),
    ("paged", 0, dict(spec_k=3, temperature=0.9, top_k=6)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("backend,moe,kw", CASES, ids=[
    "dense", "dense-sampled", "dense-moe-capacity", "paged-prefix", "paged-sampled-preempting",
    "paged-moe-capacity", "spec", "spec-sampled"])
def test_replayed_programs_give_the_eager_engine_tokens(card, backend, moe, kw):
    params = _params(card, moe_experts=moe)
    reqs = _stream()
    sampled = "temperature" in kw
    got = {}
    for graphs in (False, True):
        rng = torch.Generator(card).manual_seed(11) if sampled else None
        eng = _make(params, backend, rng=rng, cuda_graphs=graphs, **kw)
        got[graphs] = (_serve(eng, reqs), eng)
    (eager, e_eng), (replayed, g_eng) = got[False], got[True]
    for a, b in zip(eager, replayed):
        np.testing.assert_array_equal(b, a)
    st = g_eng.compile_stats()
    assert st["programs"] == e_eng.compile_stats()["programs"]
    for kind in KINDS[backend]:
        want = sum(1 for k in st["programs"] if k[0] == kind)
        assert st[f"{kind}_graph_entries"] == want, kind
        assert e_eng.compile_stats()[f"{kind}_graph_entries"] == 0
    assert st["n_programs"] >= 2
    if sampled or moe:
        return
    # greedy: the tokens are generate()'s on the card too (single requests)
    for (prompt, budget), tokens in zip(reqs, replayed):
        np.testing.assert_array_equal(tokens, _reference(params, prompt, budget))


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_a_second_stream_captures_nothing_and_a_replay_never_syncs(card, backend):
    params = _params(card)
    reqs = _stream()
    eng = _make(params, backend)
    first = _serve(eng, reqs)
    graphs = {k: p.graph for k, p in eng._progs.items()}
    captured = dict(eng.capture_s)
    assert all(g is not None for g in graphs.values())
    for a, b in zip(_serve(eng, reqs), first):
        np.testing.assert_array_equal(a, b)
    assert {k: p.graph for k, p in eng._progs.items()} == graphs
    assert eng.capture_s == captured
    # one chunk mid-stream: staging its inputs and replaying its graph
    for p, b in reqs[:3]:
        eng.submit(p, b)
    eng._admit_pending()
    eng._prefill_tick()
    assert eng.active
    b = eng.batch_size
    parts = (eng._tok, eng._pos, eng._start, eng._done, eng._remaining)
    if backend == "paged":  # as _run_chunk: blocks for the chunk, then its window
        eng._grow_for_chunk(lambda slot: min(eng.admit_every, int(eng._remaining[slot])))
        window = eng._decode_window()
        key = ("paged_chunk", eng.admit_every, b, window, eng._structure)
        parts = (eng._tables[:, :window],) + parts
    else:
        key = ("chunk", eng.admit_every, b, eng._structure)
    assert graphs[key] is not None
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        prog = eng._call(key, None, *parts)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    flat = prog.read()
    steps = int(flat[-1])
    assert 1 <= steps <= eng.admit_every and flat.size == b * eng.admit_every + 4 * b + 1
    eng.run()


@pytest.mark.cuda
def test_masked_writes_leave_the_card_null_block_as_the_cpu(card):
    """Several masked rows at one null-block slot: the card's scatter keeps
    the last one's value, as the CPU's serial scatter does."""
    b, bs = 6, 8
    tables = torch.stack([torch.arange(1 + 2 * r, 3 + 2 * r) for r in range(b)])
    pos = torch.tensor([3, 11, 3, 3, 11, 3])
    mask = torch.tensor([False, False, True, False, False, False])
    token = torch.from_numpy(np.random.default_rng(5).integers(0, 17, (b,)))
    pools = {}
    for dev in ("cpu", card):
        params = _params(dev)
        p = G.init_paged_kv(params, 1 + 2 * b, bs, n_heads=HEADS)
        p, _ = G.paged_decode_step(params, p, tables.to(dev), token.to(dev), pos.to(dev),
                                   n_heads=HEADS, block_size=bs, write_mask=mask.to(dev))
        pools[str(dev)] = [{k: t.cpu() for k, t in layer.items()} for layer in p]
    for c, g in zip(pools["cpu"], pools[str(card)]):
        for name in ("k", "v"):
            torch.testing.assert_close(g[name], c[name], rtol=1e-4, atol=1e-5)
