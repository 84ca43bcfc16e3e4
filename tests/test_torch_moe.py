"""The port's mixture of experts against the JAX package, on the CPU.

``ops/moe``: the draws are equal exactly; the forward and the gradients
(every param and the input) agree within rtol 1e-4 for dense and capacity
dispatch, top-k 1 and 2, 4 and 8 experts, with a zero row in the batch (its
router logits tie: the lowest-index experts take it) and with tokens over
capacity dropped.  The ``moe`` layer type on ``[B, F]`` and ``[B, T, D]``,
with its default capacity dispatch above 16 experts.  The MoE transformer
LM: ``init_lm_params`` draws equal to JAX's, ``params_from_jax`` carries
its params across unchanged, and 2 epochs at 2 layers give per-epoch loss
and final weights within rtol 1e-4, for both dispatches (f32, matmul
precision "highest").
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from znicz_tpu.core import prng as jprng
from znicz_tpu.core.config import root as jroot
from znicz_tpu.models import transformer_lm as jlm
from znicz_tpu.ops import moe as jmoe
from znicz_tpu.workflow import model as jmodel, transformer as jtf
from znicz_tpu_torch.core import prng as tprng
from znicz_tpu_torch.core.config import root as troot
from znicz_tpu_torch.models import transformer_lm as tlm
from znicz_tpu_torch.ops import moe as tmoe
from znicz_tpu_torch.workflow import model as model_lib, transformer as ttf

torch.set_float32_matmul_precision("highest")
torch.backends.cuda.matmul.allow_tf32 = False

RTOL, ATOL = 1e-4, 1e-6
SMALL = {
    "vocab": 16, "d_model": 32, "n_layers": 2, "n_heads": 2, "d_ff": 24,
    "loader": {"seq_len": 16, "n_train": 32, "n_test": 8, "minibatch_size": 8},
}


def _seed_both(seed):
    for reg in (jprng, tprng):
        reg.reset()
        reg.seed_all(seed)


def _params(e, f=8, h=12, seed=2):
    _seed_both(seed)
    jp = jmoe.init_params(f, h, e)
    tp = tmoe.init_params(f, h, e, device="cpu")
    tprng.reset()
    return jp, tp


def _x(b=24, f=8, seed=4):
    x = np.random.default_rng(seed).standard_normal((b, f)).astype(np.float32)
    x[3] = 0.0  # a zero row: every router logit ties
    return x


@pytest.mark.parametrize("e", [4, 8])
def test_init_params_equal_exactly(e):
    jp, tp = _params(e)
    assert list(tp) == list(jp)
    for k in jp:
        assert tp[k].dtype == torch.float32
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))


@pytest.mark.parametrize("e", [4, 8])
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("dispatch", ["dense", "capacity"])
def test_apply_and_gradients_match_jax(dispatch, top_k, e):
    jp, tp = _params(e)
    x = _x()
    kw = dict(top_k=top_k, dispatch=dispatch)

    def jloss(p, xx):
        return jnp.sum(jnp.sin(jmoe.apply(p, xx, **kw)))

    want = np.asarray(jmoe.apply(jp, jnp.asarray(x), **kw))
    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {k: w.requires_grad_(True) for k, w in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tmoe.apply(leaves, xt, **kw)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=ATOL)
    grads = torch.autograd.grad(torch.sin(got).sum(), [*leaves.values(), xt])
    for (k, g) in zip(leaves, grads[:-1]):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jgx), rtol=RTOL, atol=ATOL)
    if dispatch == "capacity":  # B 24 at factor 1.25: some experts overflow
        cap = tmoe.expert_capacity(24, e, top_k, 1.25)
        logits = torch.from_numpy(x) @ tp["router"]
        load = np.bincount(tmoe._top_k(logits, top_k)[1].reshape(-1).numpy(), minlength=e)
        assert load.max() > cap or e == 4, (load, cap)


@pytest.mark.parametrize("top_k", [1, 2])
def test_zero_row_takes_the_lowest_experts(top_k):
    jp, tp = _params(8)
    logits = torch.zeros((2, 8))
    gates = tmoe._dense_gates(logits, top_k)
    want = np.asarray(jmoe._dense_gates(jnp.zeros((2, 8)), top_k))
    np.testing.assert_allclose(gates.numpy(), want, rtol=1e-7)
    assert (gates[:, :top_k] > 0).all() and (gates[:, top_k:] == 0).all()


def test_capacity_drops_overflow_tokens():
    """Every token on expert 0 (a zero router, biased inputs): capacity
    ceil(8/4) = 2 serves tokens 0-1, the rest get 0, as in the JAX package."""
    jp, tp = _params(4, seed=9)
    jp["router"] = jnp.zeros((8, 4))
    tp["router"] = torch.zeros((8, 4))
    x = np.ones((8, 8), np.float32)
    want = np.asarray(jmoe.apply(jp, jnp.asarray(x), top_k=1, dispatch="capacity",
                                 capacity_factor=1.0))
    got = tmoe.apply(tp, torch.from_numpy(x), top_k=1, dispatch="capacity",
                     capacity_factor=1.0).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.abs(got[:2]).max() > 0
    np.testing.assert_array_equal(got[2:], 0.0)


def test_capacity_matches_dense_when_ample():
    _, tp = _params(8, seed=3)
    x = torch.from_numpy(_x(seed=5))
    dense = tmoe.apply(tp, x, top_k=2, dispatch="dense")
    cap = tmoe.apply(tp, x, top_k=2, dispatch="capacity", capacity_factor=8.0)
    torch.testing.assert_close(cap, dense, rtol=1e-5, atol=1e-6)


def test_capacity_with_top_k_of_all_experts_warns_and_runs_dense():
    jp, tp = _params(4, seed=15)
    x = _x(8)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got = tmoe.apply(tp, torch.from_numpy(x), top_k=4, dispatch="capacity")
    assert any("degrades to the dense path" in str(m.message) for m in w)
    want = np.asarray(jmoe.apply(jp, jnp.asarray(x), top_k=4, dispatch="dense"))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="unknown dispatch"):
        tmoe.apply(tp, torch.from_numpy(x), top_k=1, dispatch="sparse")


@pytest.mark.parametrize("args", [(24, 8, 2, 1.25), (8, 4, 1, 1.0), (5, 16, 1, 1.25),
                                  (32768, 8, 2, 1.25)])
def test_expert_capacity_equals_jax(args):
    assert tmoe.expert_capacity(*args) == jmoe.expert_capacity(*args)


@pytest.mark.parametrize("name", ["apply_local_shard", "expert_sharding"])
def test_expert_parallelism_is_refused_by_name(name):
    """Expert parallelism is ported (ROADMAP.md A6 is done): four shards'
    contributions, each from its block of two experts (``expert_sharding``'s
    placement, the router whole), sum to the dense dispatch within rtol
    1e-5 and atol 1e-6, as JAX's ``apply_local_shard`` does; in a world of
    one process the placement is the whole params."""
    jp, tp = _params(8, seed=11)
    x = _x(12)
    ref = np.asarray(jmoe.apply(jp, jnp.asarray(x), top_k=2))
    total = torch.zeros(12, 8)
    for s in range(4):
        if name == "apply_local_shard":
            local = {"router": tp["router"],
                     **{k: tp[k][2 * s:2 * s + 2] for k in ("w1", "b1", "w2", "b2")}}
        else:
            mesh = type("Mesh", (), {"mesh_dim_names": ("data", "model"),
                                     "mesh": torch.zeros(1, 4), "get_coordinate": lambda _, s=s: [0, s]})()
            local = tmoe.expert_sharding(mesh)(tp)
            assert local["router"] is tp["router"] and local["w1"].shape[0] == 2
        jlocal = {k: jnp.asarray(v.numpy()) for k, v in local.items()}
        got = tmoe.apply_local_shard(local, torch.from_numpy(x), top_k=2, shard_index=s)
        want = np.asarray(jmoe.apply_local_shard(jlocal, jnp.asarray(x), top_k=2, shard_index=s))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
        total += got
    np.testing.assert_allclose(total.numpy(), ref, rtol=1e-5, atol=1e-6)
    from znicz_tpu_torch.parallel import make_mesh

    whole = tmoe.expert_sharding(make_mesh())(tp)
    assert all(whole[k] is tp[k] or torch.equal(whole[k], tp[k]) for k in tp)


# -- the moe layer type --------------------------------------------------------

@pytest.mark.parametrize(
    "spec,shape",
    [
        ({"type": "moe", "n_experts": 4, "n_hidden": 12, "top_k": 2}, (8,)),
        ({"type": "moe", "n_experts": 4, "top_k": 1, "residual": False}, (2, 2, 2)),
        ({"type": "moe", "n_experts": 4, "top_k": 2, "dispatch": "capacity",
          "capacity_factor": 1.0}, (6, 8)),
        ({"type": "moe", "n_experts": 20, "n_hidden": 8, "top_k": 2}, (6, 8)),
    ],
    ids=["flat", "flattened-nonresidual", "sequence-capacity", "20-experts-default-capacity"],
)
def test_moe_layer_matches_jax(spec, shape):
    layers = [spec, {"type": "softmax", "->": {"output_sample_shape": 3}}]
    _seed_both(7)
    jm = jmodel.build(layers, shape)
    tm = model_lib.build(layers, shape, device="cpu")
    tprng.reset()
    assert tm.layer_types == jm.layer_types
    for lj, lt in zip(jm.params, tm.params):
        assert list(lt) == list(lj)
        for k in lj:
            np.testing.assert_array_equal(lt[k].numpy(), np.asarray(lj[k]))
    x = np.random.default_rng(1).standard_normal((5,) + shape).astype(np.float32)
    x[0] = 0.0
    want = np.asarray(jm.apply(jm.params, jnp.asarray(x)))
    got = tm.apply(tm.params, torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    d = shape[-1] if len(shape) == 2 else int(np.prod(shape))
    assert tm.layer_shapes[0] == (shape if len(shape) == 2 else (d,))
    if spec["n_experts"] > 16:  # the default dispatch above 16 experts: capacity
        seq = torch.from_numpy(x)
        b, t, _ = seq.shape
        layer = model_lib.build([spec], shape, device="cpu")
        tprng.reset()
        out = layer.apply([tm.params[0]], seq)
        want_cap = seq + tmoe.apply(tm.params[0], seq.reshape(b * t, d), top_k=2,
                                    dispatch="capacity").reshape(b, t, d)
        torch.testing.assert_close(out, want_cap, rtol=0, atol=0)


# -- the MoE transformer LM ----------------------------------------------------

def test_moe_lm_params_equal_exactly_and_cross_unchanged():
    _seed_both(11)
    jp = jax.device_get(jtf.init_lm_params(16, 32, 2, 2, 24, d_ff=24, moe_experts=4))
    tp = ttf.init_lm_params(16, 32, 2, 2, 24, d_ff=24, moe_experts=4, device="cpu")
    tprng.reset()
    assert list(tp[1]) == ["ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias", *ttf.MOE_KEY_MAP,
                           "wq", "wk", "wv", "wo"]
    assert tuple(tp[1]["moe_w_up"].shape) == (4, 32, 24)
    assert tuple(tp[1]["moe_w_down"].shape) == (4, 24, 32)
    for lj, lt in zip(jp, model_lib.params_to_numpy(tp)):
        assert sorted(lt) == sorted(lj)
        for k in lj:
            np.testing.assert_array_equal(lt[k], np.asarray(lj[k]))
    for lj, lt in zip(jp, model_lib.params_from_jax(jp, "cpu")):
        for k in lj:
            np.testing.assert_array_equal(lt[k].numpy(), np.asarray(lj[k]))


@pytest.mark.parametrize("dispatch", ["dense", "capacity"])
def test_moe_lm_apply_matches_jax(dispatch):
    _seed_both(12)
    jp = jtf.init_lm_params(16, 32, 2, 2, 24, d_ff=24, moe_experts=4)
    tp = model_lib.params_from_jax(jax.device_get(jp), "cpu")
    tprng.reset()
    tokens = np.random.default_rng(3).integers(0, 16, (3, 20)).astype(np.int32)
    want = jtf.lm_apply(jp, jnp.asarray(tokens), n_heads=2, moe_top_k=2, moe_dispatch=dispatch)
    got = ttf.lm_apply(tp, torch.from_numpy(tokens).long(), n_heads=2, moe_top_k=2,
                       moe_dispatch=dispatch)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=1e-5)


def _run_both(dispatch, epochs=2):
    saved, saved_j = troot.to_dict(), jroot.to_dict()
    cfg = dict(SMALL, moe_experts=4, moe_top_k=2, moe_dispatch=dispatch)
    for r in (jroot, troot):
        r.transformer_lm.update(cfg)
    try:
        _seed_both(2024)
        jwf = jlm.build_workflow(prefetch_batches=0)
        twf = tlm.build_workflow(device="cpu")
        jwf.initialize()
        twf.initialize()
        out = {"init": model_lib.params_to_numpy(twf.state.params), "jax": [], "torch": []}
        for _ in range(epochs):
            out["jax"].append(jwf.run_epoch()["summary"])
            out["torch"].append(twf.run_epoch()["summary"])
        out["jax_final"] = jax.device_get(jwf.state.params)
        out["torch_final"] = model_lib.params_to_numpy(twf.state.params)
        out["wf"] = twf
        return out
    finally:
        tprng.reset()
        troot.clear()
        troot.update(saved)
        jroot.clear()
        jroot.update(saved_j)


@pytest.fixture(scope="module", params=["dense", "capacity"])
def moe_runs(request):
    return request.param, _run_both(request.param)


def test_moe_lm_epochs_match_jax(moe_runs):
    dispatch, runs = moe_runs
    wf = runs["wf"]
    assert (wf.moe_experts, wf.moe_top_k, wf.moe_dispatch) == (4, 2, dispatch)
    for ej, et in zip(runs["jax"], runs["torch"]):
        for split in ("train", "test"):
            assert et[split]["n_samples"] == ej[split]["n_samples"]
            for k in ("loss", "token_accuracy"):
                np.testing.assert_allclose(et[split][k], ej[split][k], rtol=RTOL, err_msg=k)


def test_moe_lm_final_weights_match_jax(moe_runs):
    _, runs = moe_runs
    for lj, lt, l0 in zip(runs["jax_final"], runs["torch_final"], runs["init"]):
        for k in lj:
            assert not np.array_equal(lt[k], l0[k]) or k.endswith("scale"), k
            np.testing.assert_allclose(lt[k], np.asarray(lj[k]), rtol=RTOL, atol=1e-5,
                                       err_msg=k)
