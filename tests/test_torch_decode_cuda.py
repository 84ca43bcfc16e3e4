"""The port's decode loop on its own terms; the captured decode step on the
card.  This file imports no jax, so it runs on the card with
``python3 -m pytest --noconftest -p no:cacheprovider
tests/test_torch_decode_cuda.py -q``.

On the CPU: ``generate`` equals a plain loop of ``prefill``,
``decode_step`` and argmax (the decode program's static buffers, step
counter and done mask change nothing), with and without EOS.  On the card
(``cuda``-marked, skipped without one): the replayed CUDA graph of the
decode step gives the eager step loop's tokens (greedy, sampled from one
``torch.Generator`` state, with EOS, with MoE capacity routing), the served
program's tokens equal the eager loop's at its padded geometry (and, but
for capacity routing, which sees the pad tokens, the unpadded ones), a
second request replays the same graph, and
the decode-step logits equal ``lm_apply``'s on the card within 1e-4 of
their largest magnitude (f32, TF32 off).
"""

import numpy as np
import pytest
import torch

from znicz_tpu_torch.core import prng
from znicz_tpu_torch.workflow import generate as G
from znicz_tpu_torch.workflow.transformer import init_lm_params, lm_apply

torch.set_float32_matmul_precision("highest")
torch.backends.cuda.matmul.allow_tf32 = False

HEADS = 4


def _params(device, moe_experts=0, seed=27, max_seq=48):
    prng.reset()
    prng.seed_all(seed)
    params = init_lm_params(17, 32, 2, HEADS, max_seq, moe_experts=moe_experts, device=device)
    prng.reset()
    return params


def _prompt(device, b=3, t=5, seed=7):
    tokens = np.random.default_rng(seed).integers(0, 17, (b, t))
    return torch.from_numpy(tokens).to(device)


def _plain_greedy(params, prompt, n, eos_id=None, **kw):
    """prefill + decode_step + argmax, the loop written out."""
    b, tp = prompt.shape
    caches = G.init_kv_cache(params, b, tp + n, n_heads=HEADS)
    caches, lg = G.prefill(params, prompt, caches, n_heads=HEADS, **kw)
    toks = [lg.argmax(-1)]
    done = toks[0] == eos_id if eos_id is not None else torch.zeros(b, dtype=torch.bool)
    for i in range(1, n):
        caches, lg = G.decode_step(params, caches, toks[-1], tp + i - 1, n_heads=HEADS, **kw)
        nxt = lg.argmax(-1)
        if eos_id is not None:
            nxt = torch.where(done, eos_id, nxt)
            done = done | (nxt == eos_id)
        toks.append(nxt)
    return torch.cat([prompt, torch.stack(toks, 1)], 1).to(torch.int32)


@pytest.mark.parametrize("moe", [0, 4], ids=["dense-ffn", "moe"])
def test_generate_equals_the_plain_loop(moe):
    params = _params("cpu", moe_experts=moe)
    prompt = _prompt("cpu")
    kw = dict(moe_top_k=2) if moe else {}
    with torch.no_grad():
        want = _plain_greedy(params, prompt, 9, **kw)
    got = G.generate(params, prompt, n_heads=HEADS, max_new_tokens=9, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    eos = int(want[0, 7])
    with torch.no_grad():
        want_eos = _plain_greedy(params, prompt, 9, eos_id=eos, **kw)
    got_eos = G.generate(params, prompt, n_heads=HEADS, max_new_tokens=9, eos_id=eos, **kw)
    torch.testing.assert_close(got_eos, want_eos, rtol=0, atol=0)


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _eager(params, prompt, start=None, rung=None, **kw):
    """The eager step loop on the card (``graph=False``), with the serving
    path's left-padding (``start``) and budget rung when given."""
    return G._generate_impl(params, prompt, start, kw["max_new_tokens"],
                            kw.get("temperature", 0.0), kw.get("top_p", 1.0), kw.get("rng"),
                            n_heads=HEADS, max_new_tokens=rung or kw["max_new_tokens"],
                            greedy=kw.get("temperature", 0.0) == 0.0, top_k=kw.get("top_k", 0),
                            nucleus=kw.get("top_p", 1.0) < 1.0, eos_id=kw.get("eos_id"),
                            moe_top_k=kw.get("moe_top_k", 1),
                            moe_dispatch=kw.get("moe_dispatch", "dense"), graph=False)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "moe,kw",
    [(0, {}), (0, dict(temperature=0.9, top_k=5, top_p=0.9)), (0, dict(eos_id="emitted")),
     (4, dict(moe_top_k=2, moe_dispatch="capacity"))],
    ids=["greedy", "sampled", "eos", "moe-capacity"],
)
def test_replayed_graph_gives_the_eager_tokens(card, moe, kw):
    params = _params(card, moe_experts=moe)
    prompt = _prompt(card)
    kw = dict(kw, max_new_tokens=24)
    if kw.get("eos_id") == "emitted":
        kw["eos_id"] = int(G.generate(params, prompt, n_heads=HEADS, max_new_tokens=24)[0, 9])
    sampled = "temperature" in kw

    def rng():
        return torch.Generator(card).manual_seed(11) if sampled else None

    eager = _eager(params, prompt, **dict(kw, rng=rng()))
    graph = G.generate(params, prompt, n_heads=HEADS, rng=rng(), **kw)
    torch.cuda.synchronize()
    assert graph.is_cuda and tuple(graph.shape) == (3, 5 + 24)
    torch.testing.assert_close(graph, eager, rtol=0, atol=0)
    # the served program pads the prompt to its bucket (16) and the budget
    # to its rung (32): held to the eager loop at that geometry (capacity
    # routing sees the pad tokens too)
    padded = torch.cat([torch.zeros((3, 11), dtype=torch.long, device=card), prompt], 1)
    start = torch.full((3,), 11, dtype=torch.long, device=card)
    eager_served = _eager(params, padded, start, rung=32, **dict(kw, rng=rng()))[:, 11:11 + 29]
    if moe == 0:
        torch.testing.assert_close(eager_served, eager, rtol=0, atol=0)
    G.reset_serve_cache()
    for _ in range(2):  # a capture, then a hit replaying it
        served = G.generate_serve(params, prompt, n_heads=HEADS, rng=rng(), **kw)
        torch.testing.assert_close(served, eager_served, rtol=0, atol=0)
    stats = G.serve_cache_stats()
    assert (stats["programs"], stats["hits"]) == (1, 1)
    program = next(iter(G._serve_cache.programs.values()))
    assert program.graph is not None
    G.reset_serve_cache()


@pytest.mark.cuda
def test_decode_logits_equal_lm_apply_on_the_card(card):
    params = _params(card)
    tokens = _prompt(card, t=20)
    with torch.no_grad():
        full = lm_apply(params, tokens, n_heads=HEADS)
        caches = G.init_kv_cache(params, 3, 20, n_heads=HEADS)
        caches, lg = G.prefill(params, tokens[:, :4], caches, n_heads=HEADS)
        got = [lg]
        for p in range(4, 20):
            caches, lg = G.decode_step(params, caches, tokens[:, p],
                                       torch.tensor(p, device=card), n_heads=HEADS)
            got.append(lg)
    got = torch.stack(got, 1)
    want = full[:, 3:]
    err = float((got - want).abs().max() / want.abs().max())
    assert err < 1e-4, err
