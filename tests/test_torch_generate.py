"""The port's KV-cache decoding against the JAX package, on the CPU.

``workflow/generate.py`` at 2 layers, d_model 32, 4 heads, vocab 17 (the
JAX package's own decode goldens, ``tests/test_generate.py``): the
teacher-forced prefill and decode-step logits equal ``lm_apply``'s and JAX's
position by position within rtol 1e-4 (dense FFN and MoE), greedy tokens
equal JAX's, sampled tokens equal JAX's with its Gumbel draws
(``jax.random.gumbel(fold_in(rng, i), shape)``) handed in, left-padded
decoding equals unpadded, EOS early exit equals the full-budget run up to
EOS, ``generate_serve`` equals ``generate`` token for token with
``serve_cache_stats()`` equal to JAX's on the same request stream, every
argument error is raised.  The paged substrate: ``paged_attention`` with
aliased blocks, the prefill, decode and verify chunks and
``copy_paged_block`` (logits and the returned pools), and
``PromptLookupDrafter``'s proposals equal JAX's.  The decode step's
sampling generator is a ``torch.Generator`` where JAX takes a key, and
tensor parallelism is refused naming ROADMAP.md A6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from znicz_tpu.core import prng as jprng
from znicz_tpu.loader.fullbatch import FullBatchLoader as JaxLoader
from znicz_tpu.ops import attention as jattention
from znicz_tpu.workflow import generate as JG
from znicz_tpu.workflow.transformer import (
    TransformerLMWorkflow as JaxLM,
    init_lm_params as jinit,
    lm_apply as japply,
)
from znicz_tpu_torch.core import prng as tprng
from znicz_tpu_torch.loader.fullbatch import FullBatchLoader
from znicz_tpu_torch.observability import device as tdevice
from znicz_tpu_torch.ops import attention as tattention
from znicz_tpu_torch.workflow import generate as G, model as model_lib
from znicz_tpu_torch.workflow.transformer import TransformerLMWorkflow, lm_apply

torch.set_float32_matmul_precision("highest")
torch.backends.cuda.matmul.allow_tf32 = False

RTOL, ATOL = 1e-4, 1e-5
HEADS = 4


def _setup(moe_experts=0, seed=27, t_max=24):
    """JAX's params (its goldens' geometry) and the same values in the port."""
    jprng.seed_all(seed)
    jp = jinit(17, 32, 2, HEADS, max_seq=t_max, moe_experts=moe_experts)
    tp = model_lib.params_from_jax(jax.device_get(jp), "cpu")
    tokens = np.random.default_rng(7).integers(0, 17, (3, 12)).astype(np.int32)
    return jp, tp, tokens


def _lt(tokens):
    return torch.from_numpy(np.asarray(tokens)).long()


def _jax_noise(key):
    """JAX's per-step Gumbel draws, as ``rng`` callables of the port."""
    return lambda i, shape: np.asarray(jax.random.gumbel(jax.random.fold_in(key, i), shape))


@pytest.fixture(autouse=True)
def _fresh_serve_caches():
    JG.reset_serve_cache()
    G.reset_serve_cache()
    yield
    JG.reset_serve_cache()
    G.reset_serve_cache()


# -- decode goldens ------------------------------------------------------------

def test_teacher_forced_logits_match_full_forward():
    jp, tp, tokens = _setup()
    full = lm_apply(tp, _lt(tokens), n_heads=HEADS).numpy()
    np.testing.assert_allclose(full, np.asarray(japply(jp, jnp.asarray(tokens), n_heads=HEADS)),
                               rtol=RTOL, atol=ATOL)
    caches = G.init_kv_cache(tp, 3, 12, n_heads=HEADS)
    jc = JG.init_kv_cache(jp, 3, 12, n_heads=HEADS)
    caches, lg = G.prefill(tp, _lt(tokens[:, :4]), caches, n_heads=HEADS)
    jc, jlg = JG.prefill(jp, jnp.asarray(tokens[:, :4]), jc, n_heads=HEADS)
    np.testing.assert_allclose(lg.numpy(), full[:, 3], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=RTOL, atol=ATOL)
    for p in range(4, 12):
        # the position as an int and as a tensor (the captured step's form)
        pos = p if p % 2 else torch.tensor(p)
        caches, lg = G.decode_step(tp, caches, _lt(tokens[:, p]), pos, n_heads=HEADS)
        jc, jlg = JG.decode_step(jp, jc, jnp.asarray(tokens[:, p]), p, n_heads=HEADS)
        np.testing.assert_allclose(lg.numpy(), full[:, p], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=RTOL, atol=ATOL)
    for c, j in zip(caches, jc):
        for k in ("k", "v"):
            np.testing.assert_allclose(c[k].numpy(), np.asarray(j[k]), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dispatch", ["dense", "capacity"])
def test_moe_decode_matches_jax(dispatch):
    """The MoE FFN rides the same ``_block_ffn``: dense dispatch equals the
    full forward; capacity routes each call's own tokens, so it is held to
    JAX's decode."""
    jp, tp, tokens = _setup(moe_experts=4, seed=31)
    kw = dict(n_heads=HEADS, moe_top_k=2, moe_dispatch=dispatch)
    full = lm_apply(tp, _lt(tokens), **kw).numpy()
    caches = G.init_kv_cache(tp, 3, 12, n_heads=HEADS)
    jc = JG.init_kv_cache(jp, 3, 12, n_heads=HEADS)
    caches, lg = G.prefill(tp, _lt(tokens[:, :6]), caches, **kw)
    jc, jlg = JG.prefill(jp, jnp.asarray(tokens[:, :6]), jc, **kw)
    steps = [(lg, jlg, 5)]
    for p in range(6, 12):
        caches, lg = G.decode_step(tp, caches, _lt(tokens[:, p]), p, **kw)
        jc, jlg = JG.decode_step(jp, jc, jnp.asarray(tokens[:, p]), p, **kw)
        steps.append((lg, jlg, p))
    for lg, jlg, p in steps:
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=RTOL, atol=ATOL)
        if dispatch == "dense":
            np.testing.assert_allclose(lg.numpy(), full[:, p], rtol=RTOL, atol=ATOL)
    out = G.generate(tp, tokens[:, :4], max_new_tokens=8, **kw).numpy()
    ref = np.asarray(JG.generate(jp, jnp.asarray(tokens[:, :4]), max_new_tokens=8, **kw))
    np.testing.assert_array_equal(out, ref)


def test_greedy_generate_matches_full_reforward_and_jax():
    jp, tp, tokens = _setup()
    out = G.generate(tp, tokens[:, :4], n_heads=HEADS, max_new_tokens=8)
    assert out.dtype == torch.int32 and tuple(out.shape) == (3, 12)
    out = out.numpy()
    assert (out[:, :4] == tokens[:, :4]).all()
    full = lm_apply(tp, _lt(out), n_heads=HEADS).numpy()
    for p in range(4, 12):
        np.testing.assert_array_equal(out[:, p], np.argmax(full[:, p - 1], axis=-1))
    ref = np.asarray(JG.generate(jp, jnp.asarray(tokens[:, :4]), n_heads=HEADS,
                                 max_new_tokens=8))
    np.testing.assert_array_equal(out, ref)


def test_ids_outside_the_vocab_read_the_rows_jax_clamps_to():
    jp, tp, tokens = _setup()
    prompt = tokens[:, :6].copy()
    prompt[0, 1], prompt[1, 0], prompt[1, 4], prompt[2, 2] = 17, -1, 40, -30
    out = G.generate(tp, prompt, n_heads=HEADS, max_new_tokens=6).numpy()
    ref = np.asarray(JG.generate(jp, jnp.asarray(prompt), n_heads=HEADS, max_new_tokens=6))
    np.testing.assert_array_equal(out, ref)
    logits = lm_apply(tp, _lt(prompt), n_heads=HEADS).numpy()
    want = np.asarray(japply(jp, jnp.asarray(prompt), n_heads=HEADS))
    np.testing.assert_allclose(logits, want, rtol=RTOL, atol=ATOL)


def test_temperature_sampling_reproducible_and_in_vocab():
    _, tp, tokens = _setup()
    kw = dict(n_heads=HEADS, max_new_tokens=6, temperature=0.8)

    def run(seed):
        return G.generate(tp, tokens[:, :4], rng=torch.Generator().manual_seed(seed),
                          **kw).numpy()

    a, b, c = run(5), run(5), run(6)
    np.testing.assert_array_equal(a, b)  # same generator state -> same draw
    assert (a[:, 4:] >= 0).all() and (a[:, 4:] < 17).all()
    assert not (a == c).all()


@pytest.mark.parametrize(
    "sampling",
    [dict(temperature=0.8), dict(temperature=1.3, top_k=2), dict(temperature=1.0, top_p=0.9),
     dict(temperature=0.7, top_k=5, top_p=0.8), dict(temperature=-0.9)],
    ids=["temperature", "top_k", "top_p", "top_k+top_p", "negative-temperature"],
)
def test_sampling_with_jax_draws_gives_jax_tokens(sampling):
    """A negative temperature passes validation and samples from the
    inverted distribution, as in the JAX package."""
    jp, tp, tokens = _setup()
    key = jax.random.key(3)
    ref = np.asarray(JG.generate(jp, jnp.asarray(tokens[:, :4]), n_heads=HEADS,
                                 max_new_tokens=8, rng=key, **sampling))
    out = G.generate(tp, tokens[:, :4], n_heads=HEADS, max_new_tokens=8,
                     rng=_jax_noise(key), **sampling).numpy()
    np.testing.assert_array_equal(out, ref)
    serve = G.generate_serve(tp, tokens[:, :4], n_heads=HEADS, max_new_tokens=8,
                             rng=_jax_noise(key), **sampling).numpy()
    jserve = np.asarray(JG.generate_serve(jp, tokens[:, :4], n_heads=HEADS, max_new_tokens=8,
                                          rng=key, **sampling))
    np.testing.assert_array_equal(serve, jserve)


def test_capacity_exceeded_raises():
    _, tp, tokens = _setup(t_max=10)
    with pytest.raises(ValueError, match="positional table"):
        G.generate(tp, tokens[:, :4], n_heads=HEADS, max_new_tokens=8)


def _lm_workflows():
    tokens = np.random.default_rng(3).integers(0, 16, (16, 24)).astype(np.int32)
    wfs = []
    for prng, loader_cls, cls, kw in ((jprng, JaxLoader, JaxLM, {"prefetch_batches": 0}),
                                      (tprng, FullBatchLoader, TransformerLMWorkflow,
                                       {"device": "cpu"})):
        prng.reset()
        prng.seed_all(77)
        wf = cls(loader_cls({"train": tokens.copy()}, minibatch_size=8), vocab=16, d_model=16,
                 n_layers=1, n_heads=2, max_epochs=1, **kw)
        wf.initialize(seed=77)
        wf.run()
        wfs.append(wf)
    tprng.reset()
    return tokens, wfs


def test_workflow_generate_method():
    """Train one epoch in both, then ``wf.generate``: the port's tokens equal
    JAX's module-level decode of the port's weights and JAX's own
    workflow's."""
    tokens, (jwf, twf) = _lm_workflows()
    out = twf.generate(tokens[:2, :6], max_new_tokens=8)
    assert out.shape == (2, 14) and out.device.type == "cpu"
    host = model_lib.params_to_numpy(twf.state.params)
    ref = np.asarray(JG.generate(jax.tree_util.tree_map(jnp.asarray, host),
                                 jnp.asarray(tokens[:2, :6]), n_heads=2, max_new_tokens=8))
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(jwf.generate(tokens[:2, :6], max_new_tokens=8)))


def test_workflow_generate_decodes_moe_with_its_routing():
    tokens = np.random.default_rng(4).integers(0, 16, (8, 16)).astype(np.int32)
    tprng.reset()
    tprng.seed_all(5)
    wf = TransformerLMWorkflow(FullBatchLoader({"train": tokens}, minibatch_size=8), vocab=16,
                               d_model=16, n_layers=1, n_heads=2, moe_experts=4, moe_top_k=2,
                               moe_dispatch="capacity", device="cpu")
    tprng.reset()
    out = wf.generate(tokens[:2, :4], max_new_tokens=5).numpy()
    host = model_lib.params_to_numpy(wf.state.params)
    ref = np.asarray(JG.generate(jax.tree_util.tree_map(jnp.asarray, host),
                                 jnp.asarray(tokens[:2, :4]), n_heads=2, max_new_tokens=5,
                                 moe_top_k=2, moe_dispatch="capacity"))
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("kwargs,item", [({"tensor_parallel": True}, "A6"),
                                         ({"pipeline_parallel": True}, "A7")],
                         ids=["tensor_parallel", "pipeline_parallel"])
def test_sharded_and_pipelined_decode_is_refused_by_name(kwargs, item):
    """The JAX package decodes TP-sharded params and refuses pipelined ones;
    the port refuses both layouts where they are made."""
    loader = FullBatchLoader({"train": np.zeros((2, 8), np.int32)}, minibatch_size=2)
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
        TransformerLMWorkflow(loader, vocab=8, device="cpu", **kwargs)


def test_temperature_without_rng_raises():
    _, tp, tokens = _setup()
    with pytest.raises(ValueError, match="rng"):
        G.generate(tp, tokens[:, :4], n_heads=HEADS, max_new_tokens=2, temperature=0.7)


# -- sampling truncation -------------------------------------------------------

def test_top_k_1_equals_greedy():
    _, tp, tokens = _setup()
    greedy = G.generate(tp, tokens[:, :4], n_heads=HEADS, max_new_tokens=6)
    k1 = G.generate(tp, tokens[:, :4], n_heads=HEADS, max_new_tokens=6, temperature=1.0,
                    top_k=1, rng=torch.Generator().manual_seed(2))
    torch.testing.assert_close(greedy, k1, rtol=0, atol=0)


def test_tiny_top_p_equals_greedy():
    _, tp, tokens = _setup()
    greedy = G.generate(tp, tokens[:, :4], n_heads=HEADS, max_new_tokens=6)
    p0 = G.generate(tp, tokens[:, :4], n_heads=HEADS, max_new_tokens=6, temperature=1.0,
                    top_p=1e-6, rng=torch.Generator().manual_seed(2))
    torch.testing.assert_close(greedy, p0, rtol=0, atol=0)


def test_top_k_restricts_support():
    _, tp, tokens = _setup()
    out = G.generate(tp, tokens[:, :4], n_heads=HEADS, max_new_tokens=8, temperature=1.3,
                     top_k=2, rng=torch.Generator().manual_seed(3)).numpy()
    full = lm_apply(tp, _lt(out), n_heads=HEADS).numpy()
    for p in range(4, 12):
        top2 = np.argsort(full[:, p - 1], axis=-1)[:, -2:]
        for b in range(out.shape[0]):
            assert out[b, p] in top2[b], (b, p)


@pytest.mark.parametrize("kwargs,match", [
    (dict(temperature=1.0, top_p=0.0), "top_k"),
    (dict(temperature=1.0, top_p=1.5), "top_k"),
    (dict(temperature=1.0, top_k=-1), "top_k"),
    (dict(eos_id=17), "eos_id"),
    (dict(eos_id=-1), "eos_id"),
], ids=["top_p-0", "top_p-above-1", "negative-top_k", "eos-past-vocab", "negative-eos"])
def test_bad_arguments_rejected(kwargs, match):
    _, tp, tokens = _setup()
    for fn in (G.generate, G.generate_serve):
        with pytest.raises(ValueError, match=match):
            fn(tp, tokens[:, :4], n_heads=HEADS, max_new_tokens=2,
               rng=torch.Generator(), **kwargs)


def test_top_k_above_vocab_clamps_to_full_support():
    _, tp, tokens = _setup()
    out = G.generate(tp, tokens[:, :4], n_heads=HEADS, max_new_tokens=4, temperature=1.0,
                     top_k=17 + 30, rng=torch.Generator().manual_seed(1))
    ref = G.generate(tp, tokens[:, :4], n_heads=HEADS, max_new_tokens=4, temperature=1.0,
                     rng=torch.Generator().manual_seed(1))
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


def test_temperature_sweep_reuses_one_program():
    """temperature and top_p are operands of the program, not its key."""
    _, tp, tokens = _setup()
    kw = dict(n_heads=HEADS, max_new_tokens=3, rng=torch.Generator())
    G.generate_serve(tp, tokens[:, :4], temperature=0.7, top_p=0.9, **kw)
    G.generate_serve(tp, tokens[:, :4], temperature=1.3, top_p=0.8, **kw)
    st = G.serve_cache_stats()
    assert (st["programs"], st["hits"], st["compiles"]) == (1, 1, 1)


# -- serving -------------------------------------------------------------------

def test_bucket_for_ladder():
    for n, ladder in ((1, (16, 32)), (16, (16, 32)), (17, (16, 32)), (33, (16, 32)),
                      (200, (16, 32)), (120, G.DEFAULT_PROMPT_BUCKETS)):
        assert G.bucket_for(n, ladder) == JG.bucket_for(n, ladder)
    assert G.bucket_for(200, (16, 32)) == 256
    with pytest.raises(ValueError, match="positive"):
        G.bucket_for(0, (16,))


def test_pack_prompts_left_pads_ragged():
    prompts = [np.asarray([1, 2, 3]), np.asarray([4])]
    toks, start = G.pack_prompts(prompts, 8, pad_id=7)
    jt, js = JG.pack_prompts(prompts, 8, pad_id=7)
    assert toks.dtype == start.dtype == torch.int32
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(start.numpy(), [5, 7])
    with pytest.raises(ValueError, match="empty"):
        G.pack_prompts([np.asarray([], np.int32)], 8, pad_id=0)
    with pytest.raises(ValueError, match="exceeds bucket"):
        G.pack_prompts([np.arange(9)], 8, pad_id=0)


def test_left_padded_decode_matches_unpadded_per_position():
    _, tp, tokens = _setup()
    full = lm_apply(tp, _lt(tokens), n_heads=HEADS).numpy()
    bucket = 16
    padded, start = G.pack_prompts(list(tokens[:, :5]), bucket, pad_id=0)
    start = start.long()
    caches = G.init_kv_cache(tp, 3, bucket + 7, n_heads=HEADS)
    caches, lg = G.prefill(tp, padded, caches, n_heads=HEADS, start=start)
    np.testing.assert_allclose(lg.numpy(), full[:, 4], rtol=RTOL, atol=ATOL)
    for p in range(5, 12):
        caches, lg = G.decode_step(tp, caches, _lt(tokens[:, p]), bucket + p - 5,
                                   n_heads=HEADS, start=start)
        np.testing.assert_allclose(lg.numpy(), full[:, p], rtol=RTOL, atol=ATOL)


def test_generate_serve_matches_generate_token_for_token():
    jp, tp, tokens = _setup()
    ref = G.generate(tp, tokens[:, :5], n_heads=HEADS, max_new_tokens=6)
    out = G.generate_serve(tp, tokens[:, :5], n_heads=HEADS, max_new_tokens=6)
    assert out.dtype == torch.int32
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(JG.generate_serve(jp, tokens[:, :5], n_heads=HEADS,
                                                  max_new_tokens=6)))


def test_eos_early_exit_matches_full_budget_up_to_eos():
    jp, tp, tokens = _setup()
    ref = G.generate(tp, tokens[:, :4], n_heads=HEADS, max_new_tokens=8).numpy()
    eos = int(ref[0, 4 + 2])
    out = G.generate(tp, tokens[:, :4], n_heads=HEADS, max_new_tokens=8, eos_id=eos).numpy()
    assert (out[:, :4] == tokens[:, :4]).all()
    for b in range(out.shape[0]):
        new_ref, new_out = ref[b, 4:], out[b, 4:]
        hit = np.where(new_ref == eos)[0]
        k = hit[0] + 1 if len(hit) else len(new_ref)
        np.testing.assert_array_equal(new_out[:k], new_ref[:k])
        assert (new_out[k:] == eos).all()
    np.testing.assert_array_equal(
        out, np.asarray(JG.generate(jp, jnp.asarray(tokens[:, :4]), n_heads=HEADS,
                                    max_new_tokens=8, eos_id=eos)))


def test_serve_eos_matches_generate_eos():
    _, tp, tokens = _setup()
    ref = G.generate(tp, tokens[:, :5], n_heads=HEADS, max_new_tokens=7).numpy()
    eos = int(ref[1, 5 + 1])
    a = G.generate(tp, tokens[:, :5], n_heads=HEADS, max_new_tokens=7, eos_id=eos)
    b = G.generate_serve(tp, tokens[:, :5], n_heads=HEADS, max_new_tokens=7, eos_id=eos)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def _stats_both(jp, tp, stream):
    """The same request stream through both serving paths; the tokens
    equal, then both ``serve_cache_stats()``."""
    for prompt, kw in stream:
        jkw = dict(kw)
        if "rng" in kw:
            jkw["rng"] = jax.random.key(kw["rng"])
            kw = dict(kw, rng=_jax_noise(jkw["rng"]))
        out = G.generate_serve(tp, prompt, n_heads=HEADS, **kw).numpy()
        ref = np.asarray(JG.generate_serve(jp, prompt, n_heads=HEADS, **jkw))
        np.testing.assert_array_equal(out, ref)
    jst, tst = JG.serve_cache_stats(), G.serve_cache_stats()
    jst.pop("jit_entries")
    return jst, tst


def test_second_request_same_bucket_zero_recompiles():
    jp, tp, tokens = _setup()
    G.generate_serve(tp, tokens[:, :5], n_heads=HEADS, max_new_tokens=6)
    st0 = G.serve_cache_stats()
    assert st0["programs"] == 1 and st0["hits"] == 0
    out = G.generate_serve(tp, tokens[:, :9], n_heads=HEADS, max_new_tokens=3)
    st1 = G.serve_cache_stats()
    assert st1["programs"] == 1 and st1["hits"] == 1 and st1["requests"] == 2
    ref = G.generate(tp, tokens[:, :9], n_heads=HEADS, max_new_tokens=3)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    G.generate_serve(tp, tokens[:, :5], n_heads=HEADS, max_new_tokens=6, temperature=0.8,
                     rng=torch.Generator().manual_seed(1))
    assert G.serve_cache_stats()["programs"] == 2
    # the same stream through the JAX package counts the same
    G.reset_serve_cache()
    stream = [(tokens[:, :5], dict(max_new_tokens=6)), (tokens[:, :9], dict(max_new_tokens=3)),
              (tokens[:, :5], dict(max_new_tokens=6, temperature=0.8, rng=1)),
              (tokens[:2, :12], dict(max_new_tokens=2, eos_id=3))]
    jst, tst = _stats_both(jp, tp, stream)
    assert tst == jst
    assert (tst["programs"], tst["hits"], tst["requests"]) == (3, 1, 4)


def test_serve_records_each_program_in_the_ledger():
    _, tp, tokens = _setup(t_max=48)
    before = tdevice.program_count("serve_cache")
    G.generate_serve(tp, tokens[:, :5], n_heads=HEADS, max_new_tokens=6)
    G.generate_serve(tp, tokens[:, :7], n_heads=HEADS, max_new_tokens=6)
    G.generate_serve(tp, tokens[:, :5], n_heads=HEADS, max_new_tokens=20)
    assert tdevice.program_count("serve_cache") == before + 2
    entry = tdevice.programs("serve_cache")[-1]
    assert entry["kind"] == "serve" and entry["key"] == str(("serve", 16, 32, 3, True, 0, False))
    snap = tdevice.ledger_snapshot()
    assert snap["by_kind"]["serve"] >= 2 and snap["compile_seconds_total"] >= 0
    assert tdevice.compile_seconds_total() == snap["compile_seconds_total"]


def test_serve_sampling_reproducible():
    _, tp, tokens = _setup()
    kw = dict(n_heads=HEADS, max_new_tokens=5, temperature=0.9)
    a = G.generate_serve(tp, tokens[:, :5], rng=torch.Generator().manual_seed(4), **kw)
    b = G.generate_serve(tp, tokens[:, :5], rng=torch.Generator().manual_seed(4), **kw)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (a[:, 5:] >= 0).all() and (a[:, 5:] < 17).all()


def test_zero_budget_rejected_with_clear_error():
    _, tp, tokens = _setup()
    for fn in (G.generate, G.generate_serve):
        with pytest.raises(ValueError, match="max_new_tokens"):
            fn(tp, tokens[:, :4], n_heads=HEADS, max_new_tokens=0)


def test_serve_capacity_clamps_then_falls_back_exact():
    jp, tp, tokens = _setup(t_max=24)
    for n in (8, 9):  # 16 + 16 > 24: the rung clamps; at 9 it underruns: exact
        ref = G.generate(tp, tokens[:, :5], n_heads=HEADS, max_new_tokens=n)
        out = G.generate_serve(tp, tokens[:, :5], n_heads=HEADS, max_new_tokens=n)
        torch.testing.assert_close(out, ref, rtol=0, atol=0)
    with pytest.raises(ValueError, match="positional table"):
        G.generate_serve(tp, tokens[:, :5], n_heads=HEADS, max_new_tokens=25)
    tst = G.serve_cache_stats()
    G.reset_serve_cache()
    for n in (8, 9):
        JG.generate_serve(jp, tokens[:, :5], n_heads=HEADS, max_new_tokens=n)
    jst = JG.serve_cache_stats()
    jst.pop("jit_entries")
    assert tst == jst and tst["programs"] == 2


# -- the paged substrate -------------------------------------------------------

def _paged_attention_case(seed=5):
    """Three rows whose first block is one shared (aliased) pool block, at
    different depths through it, with left-padding on one row."""
    rng = np.random.default_rng(seed)
    bs, h, d, m = 8, 2, 8, 3
    n_blocks = 2 + 3 * (m - 1)
    k_pool = rng.normal(size=(n_blocks, bs, h, d)).astype(np.float32)
    v_pool = rng.normal(size=(n_blocks, bs, h, d)).astype(np.float32)
    table = np.zeros((3, m), np.int32)
    table[:, 0] = 1
    table[:, 1:] = np.arange(2, n_blocks).reshape(3, m - 1)
    q = rng.normal(size=(3, 2, h, d)).astype(np.float32)
    q_pos = np.asarray([[4, 5], [12, 13], [20, 21]], np.int32)
    start = np.asarray([0, 3, 0], np.int32)
    return q, k_pool, v_pool, table, q_pos, start, bs


@pytest.mark.parametrize("with_start", [False, True], ids=["no-start", "start"])
def test_paged_attention_with_aliased_blocks_matches_jax(with_start):
    q, k_pool, v_pool, table, q_pos, start, bs = _paged_attention_case()
    js = jnp.asarray(start) if with_start else None
    ts = torch.from_numpy(start).long() if with_start else None
    want = np.asarray(jattention.paged_attention(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool), jnp.asarray(table),
        jnp.asarray(q_pos), block_size=bs, start=js))
    got = tattention.paged_attention(
        torch.from_numpy(q), torch.from_numpy(k_pool), torch.from_numpy(v_pool),
        torch.from_numpy(table).long(), torch.from_numpy(q_pos).long(), block_size=bs,
        start=ts).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)
    # per-row validity through the shared block: positions 5..7 of block 1
    # are live for rows 1 and 2, masked for row 0's query at 4
    k2 = k_pool.copy()
    k2[1, 5:] += 3.0
    got2 = tattention.paged_attention(
        torch.from_numpy(q), torch.from_numpy(k2), torch.from_numpy(v_pool),
        torch.from_numpy(table).long(), torch.from_numpy(q_pos).long(), block_size=bs,
        start=ts).numpy()
    np.testing.assert_array_equal(got2[0, 0], got[0, 0])
    assert not np.allclose(got2[1:], got[1:])


def _pools_equal(tpools, jpools, skip_null=False):
    for tp_, jp_ in zip(tpools, jpools):
        for k in ("k", "v"):
            a, b = tp_[k].numpy(), np.asarray(jp_[k])
            if skip_null:  # rows routed to the null block may collide there
                a, b = a[1:], b[1:]
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("moe", [0, 4], ids=["dense-ffn", "moe"])
def test_paged_chunks_match_jax(moe):
    """Chunked prefill of two prompts (one ending in a right-padded chunk
    with ``last``), two decode steps (the second with a row masked to the
    null block), a verify chunk and a copy-on-write split, each step's
    logits and returned pools against JAX's; the chunk's offset and
    ``last`` also as tensors."""
    jp, tp, _ = _setup(moe_experts=moe, seed=41, t_max=48)
    kw = dict(n_heads=HEADS, block_size=8, moe_top_k=2 if moe else 1)
    rng = np.random.default_rng(9)
    p0 = rng.integers(0, 17, 13).astype(np.int32)
    p1 = rng.integers(0, 17, 8).astype(np.int32)
    tables = np.asarray([[3, 5, 7, 0], [2, 4, 6, 0]], np.int32)
    tt = torch.from_numpy(tables)
    tpools = G.init_paged_kv(tp, 10, 8, n_heads=HEADS)
    jpools = JG.init_paged_kv(jp, 10, 8, n_heads=HEADS)
    chunk1 = np.concatenate([p0[8:], np.zeros(3, np.int32)])[None]
    for row, toks, off, last in ((0, p0[None, :8], 0, None), (0, chunk1, 8, 4),
                                 (1, p1[None], 0, None)):
        t_off = torch.tensor(off) if row == 0 else off
        t_last = torch.tensor(last) if last is not None else None
        tpools, lg = G.paged_prefill_chunk(tp, tpools, tt[row], _lt(toks), t_off, last=t_last,
                                           **kw)
        jpools, jlg = JG.paged_prefill_chunk(jp, jpools, jnp.asarray(tables[row]),
                                             jnp.asarray(toks), off, last=last, **kw)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=RTOL, atol=ATOL)
        _pools_equal(tpools, jpools)
    token = np.asarray([5, 9], np.int32)
    for pos, mask in (([13, 8], None), ([14, 9], [True, False])):
        pos = np.asarray(pos, np.int32)
        tm = None if mask is None else torch.tensor(mask)
        jm = None if mask is None else jnp.asarray(mask)
        tpools, lg = G.paged_decode_step(tp, tpools, tt, _lt(token), _lt(pos), write_mask=tm,
                                         **kw)
        jpools, jlg = JG.paged_decode_step(jp, jpools, jnp.asarray(tables), jnp.asarray(token),
                                           jnp.asarray(pos), write_mask=jm, **kw)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=RTOL, atol=ATOL)
        _pools_equal(tpools, jpools, skip_null=mask is not None)
    draft = np.asarray([[1, 2, 3], [4, 5, 6]], np.int32)
    vpos = np.asarray([15, 9], np.int32)
    vmask = np.asarray([[True, True, True], [True, True, False]])
    tpools, lg = G.paged_verify_chunk(tp, tpools, tt, _lt(draft), _lt(vpos),
                                      write_mask=torch.from_numpy(vmask), **kw)
    jpools, jlg = JG.paged_verify_chunk(jp, jpools, jnp.asarray(tables), jnp.asarray(draft),
                                        jnp.asarray(vpos), write_mask=jnp.asarray(vmask), **kw)
    assert tuple(lg.shape) == (2, 3, 17)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=RTOL, atol=ATOL)
    _pools_equal(tpools, jpools, skip_null=True)
    for src, dst in ((3, 8), (torch.tensor(2), torch.tensor(9))):
        tpools = G.copy_paged_block(tpools, src, dst)
        jpools = JG.copy_paged_block(jpools, int(src), int(dst))
        _pools_equal(tpools, jpools, skip_null=True)


def test_paged_prefill_and_pool_arguments_are_checked():
    _, tp, tokens = _setup()
    with pytest.raises(ValueError, match="n_blocks >= 2"):
        G.init_paged_kv(tp, 1, 8, n_heads=HEADS)
    pools = G.init_paged_kv(tp, 4, 8, n_heads=HEADS)
    assert tuple(pools[0]["k"].shape) == (4, 8, HEADS, 8)
    with pytest.raises(ValueError, match="one chunk == one block"):
        G.paged_prefill_chunk(tp, pools, torch.tensor([1, 2]), _lt(tokens[:1, :5]), 0,
                              n_heads=HEADS, block_size=8)


@pytest.mark.parametrize(
    "context,k,ngrams",
    [([1, 2, 3, 4, 1, 2, 3], 3, (3, 2)), ([5, 6, 5, 6, 5, 6], 4, (3, 2)),
     ([1, 2, 3, 4, 5], 2, (3, 2)), ([7, 8, 9, 7, 8], 0, (3, 2)), ([3, 1, 3, 2, 3], 2, (3, 1)),
     ([9, 9, 9, 9, 9, 9, 9], 5, (3, 1))],
    ids=["repeat", "periodic", "no-match", "k-0", "unigram", "one-token-run"],
)
def test_prompt_lookup_drafter_equals_jax(context, k, ngrams):
    got = G.PromptLookupDrafter(*ngrams).propose(np.asarray(context), k)
    want = JG.PromptLookupDrafter(*ngrams).propose(np.asarray(context), k)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="ngram_min"):
        G.PromptLookupDrafter(1, 2)
