"""The rest of the declarative layer vocabulary and the small ops of the
port against the JAX package, on the CPU: max-abs, max-with-offset and
stochastic pooling, the cutter, every ``activation_<name>``, the range
accumulator, weight zero-filling, the resizable FC layer, and the CIFAR-10
and Wine readers.

Inputs come from a numpy seed.  A pooling op's pick is compared exactly (the
same element of the same window, first-index tie breaking; offsets as
integers), and so is the stochastic pool's training output given JAX's own
``jax.random.gumbel`` draws.  Sums in another order agree within rtol 1e-6 /
atol 1e-7: the gradients (a window's picks add where windows overlap), the
stochastic pool's evaluation output (an expectation over each window), the
accumulator's sums and the update rule.  Activations and the stochastic
pool's evaluation gradient agree within rtol 1e-5 / atol 1e-6 (XLA's CPU
``tanh`` is 2 ulp off, and ``1 - tanh^2`` magnifies that near saturation;
the expectation's gradient sums a quotient's derivative over the window,
with cancellation), whole models within rtol 1e-5 (forward) and 1e-4 /
atol 1e-6 (gradients), f32 with matmul precision "highest" and TF32 off.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from znicz_tpu.core import prng as jprng
from znicz_tpu.loader import datasets as jax_datasets
from znicz_tpu.nn import optimizer as jax_opt
from znicz_tpu.ops import (
    accumulator as jax_acc,
    cutter as jax_cutter,
    pooling as jax_pooling,
    resizable_all2all as jax_resizable,
    weights_zerofilling as jax_zf,
)
from znicz_tpu.workflow import model as jax_model
from znicz_tpu_torch.core import prng as tprng
from znicz_tpu_torch.loader import datasets
from znicz_tpu_torch.nn import optimizer
from znicz_tpu_torch.ops import (
    accumulator,
    cutter,
    pooling,
    resizable_all2all,
    weights_zerofilling,
)
from znicz_tpu_torch.workflow import model as model_lib

torch.set_float32_matmul_precision("highest")
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

SEED = 2024
GRAD_TOL = dict(rtol=1e-6, atol=1e-7)
SMOOTH_TOL = dict(rtol=1e-5, atol=1e-6)
MODEL_FWD_RTOL = 1e-5
MODEL_GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
POOL_CASES = [(2, 2, None), (3, 3, (2, 2)), (3, 2, (1, 2)), (2, 3, (2, 1))]  # (kx, ky, sliding)
POOL_IDS = ["k2", "k3s2", "kx3ky2s1x2", "kx2ky3s2x1"]


def _seed_both(seed=SEED):
    for reg in (jprng, tprng):
        reg.reset()
        reg.seed_all(seed)


def _jax_vjp(f, x, g):
    y, vjp = jax.vjp(f, jnp.asarray(x))
    return np.asarray(y), np.asarray(vjp(jnp.asarray(g))[0])


def _torch_vjp(f, x, g):
    xt = torch.from_numpy(x).requires_grad_(True)
    y = f(xt)
    (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    return y.detach().numpy(), dx.numpy()


def _tied(shape, seed):
    """Small integers of both signs: many ties in value and in magnitude."""
    return np.random.default_rng(seed).integers(-3, 4, shape).astype(np.float32)


def _cotangent(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# -- pooling -------------------------------------------------------------------

@pytest.mark.parametrize("kx,ky,sliding", POOL_CASES, ids=POOL_IDS)
def test_max_abs_pool_with_ties_matches_jax(kx, ky, sliding):
    x = _tied((2, 7, 8, 3), 0)
    shape = jax_pooling.output_shape(x.shape, kx, ky, sliding)
    g = _cotangent(shape, 1)
    yj, dj = _jax_vjp(lambda v: jax_pooling.max_abs_pool(v, kx, ky, sliding), x, g)
    yt, dt = _torch_vjp(lambda v: pooling.max_abs_pool(v, kx, ky, sliding), x, g)
    np.testing.assert_array_equal(yt, yj)
    np.testing.assert_allclose(dt, dj, **GRAD_TOL)


@pytest.mark.parametrize("kx,ky,sliding", POOL_CASES, ids=POOL_IDS)
def test_max_pool_with_offset_matches_jax(kx, ky, sliding):
    x = _tied((2, 7, 8, 3), 2)
    vj, oj = jax_pooling.max_pool_with_offset(jnp.asarray(x), kx, ky, sliding)
    vt, ot = pooling.max_pool_with_offset(torch.from_numpy(x), kx, ky, sliding)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert ot.dtype == torch.int64
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    # each offset points at its value, inside the input plane
    flat = torch.from_numpy(x).reshape(2, -1, 3)
    picked = torch.gather(flat, 1, ot.reshape(2, -1, 3))
    np.testing.assert_array_equal(picked.reshape(vt.shape).numpy(), vt.numpy())
    g = _cotangent(vt.shape, 3)
    _, dj = _jax_vjp(lambda v: jax_pooling.max_pool_with_offset(v, kx, ky, sliding)[0], x, g)
    _, dt = _torch_vjp(lambda v: pooling.max_pool_with_offset(v, kx, ky, sliding)[0], x, g)
    np.testing.assert_allclose(dt, dj, **GRAD_TOL)


def _stochastic_input(seed):
    """Normal values with some windows all non-positive (the max-abs
    fallback) and some exact zeros."""
    x = np.random.default_rng(seed).standard_normal((2, 6, 6, 4)).astype(np.float32)
    x[0, :2, :2, :] = -np.abs(x[0, :2, :2, :])
    x[1, 2:4, 2:4, 1] = 0.0
    return x


@pytest.mark.parametrize("kx,ky,sliding", POOL_CASES, ids=POOL_IDS)
def test_stochastic_pool_eval_matches_jax(kx, ky, sliding):
    x = _stochastic_input(4)
    shape = jax_pooling.output_shape(x.shape, kx, ky, sliding)
    g = _cotangent(shape, 5)
    yj, dj = _jax_vjp(
        lambda v: jax_pooling.stochastic_pool(v, kx, ky, sliding, train=False), x, g)
    yt, dt = _torch_vjp(
        lambda v: pooling.stochastic_pool(v, kx, ky, sliding, train=False), x, g)
    np.testing.assert_allclose(yt, yj, **GRAD_TOL)
    # JAX's gradient is NaN in a window with no positive value (0/0 in the
    # derivative of p / max(total, 1e-30), whose square underflows); the
    # port's is 0 there, which is the derivative of the constant 0 output
    finite = np.isfinite(dj)
    assert np.isfinite(dt).all() and (dt[~finite] == 0).all()
    np.testing.assert_allclose(dt[finite], dj[finite], **SMOOTH_TOL)


@pytest.mark.parametrize("kx,ky,sliding", POOL_CASES, ids=POOL_IDS)
def test_stochastic_pool_train_given_jax_gumbel_draws(kx, ky, sliding):
    x = _stochastic_input(6)
    key = jax.random.PRNGKey(7)
    n, oh, ow, c = jax_pooling.output_shape(x.shape, kx, ky, sliding)
    noise = np.asarray(jax.random.gumbel(key, (n, oh, ow, kx * ky, c), jnp.float32))
    g = _cotangent((n, oh, ow, c), 8)
    yj, dj = _jax_vjp(
        lambda v: jax_pooling.stochastic_pool(v, kx, ky, sliding, rng=key, train=True), x, g)
    yt, dt = _torch_vjp(
        lambda v: pooling.stochastic_pool(v, kx, ky, sliding, train=True,
                                          noise=torch.from_numpy(noise.copy())), x, g)
    np.testing.assert_array_equal(yt, yj)
    np.testing.assert_allclose(dt, dj, **GRAD_TOL)


def test_stochastic_pool_draws_in_proportion_to_the_positive_part():
    """From the generator: each window's element is drawn with probability
    proportional to its positive part (within 5 sigma over 40,000 windows);
    a window without a positive value takes its max-abs element."""
    n = 40_000
    x = torch.tensor([1.0, 2.0, 3.0, 0.0, -5.0, 4.0]).repeat(n, 1)
    x = torch.cat([x[:, :4], x[:, 4:]], dim=1).reshape(n, 2, 3, 1)  # one 2x3 window
    gen = torch.Generator().manual_seed(0)
    y = pooling.stochastic_pool(x, 3, 2, generator=gen, train=True).reshape(n)
    p = np.array([1.0, 2.0, 3.0, 4.0]) / 10.0
    for value, pv in zip((1.0, 2.0, 3.0, 4.0), p):
        freq = float((y == value).float().mean())
        assert abs(freq - pv) < 5 * np.sqrt(pv * (1 - pv) / n), (value, freq, pv)
    assert not bool((y == -5.0).any()) and not bool((y == 0.0).any())
    neg = -torch.tensor([[1.0, 3.0], [2.0, 0.5]]).reshape(1, 2, 2, 1)
    assert float(pooling.stochastic_pool(neg, 2, 2, generator=gen)) == -3.0
    with pytest.raises(ValueError, match="Generator"):
        pooling.stochastic_pool(neg, 2, 2, train=True)


# -- cutter and activations ------------------------------------------------------

@pytest.mark.parametrize("padding", [(1, 2, 0, 1), (0, 0, 0, 0), (2, 1, 3, 2)])
def test_cutter_matches_jax(padding):
    x = _cotangent((2, 7, 9, 3), 9)
    shape = jax_cutter.output_shape(x.shape, padding)
    assert cutter.output_shape(x.shape, padding) == shape
    g = _cotangent(shape, 10)
    yj, dj = _jax_vjp(lambda v: jax_cutter.cut(v, padding), x, g)
    yt, dt = _torch_vjp(lambda v: cutter.cut(v, padding), x, g)
    assert yt.shape == shape
    np.testing.assert_array_equal(yt, yj)
    np.testing.assert_array_equal(dt, dj)


@pytest.mark.parametrize("name", ["linear", "tanh", "relu", "strict_relu", "sigmoid", "log"])
def test_activation_layer_matches_jax(name):
    spec = [{"type": f"activation_{name}"}]
    jm = jax_model.build(spec, (4, 5, 3))
    tm = model_lib.build(spec, (4, 5, 3), device="cpu")
    assert tm.output_shape == jm.output_shape == (4, 5, 3)
    assert tm.layer_specs == jm.layer_specs == ({"type": f"activation_{name}"},)
    x = 3.0 * _cotangent((2, 4, 5, 3), 11)
    g = _cotangent(x.shape, 12)
    yj, dj = _jax_vjp(lambda v: jm.apply(jm.params, v), x, g)
    yt, dt = _torch_vjp(lambda v: tm.apply(tm.params, v), x, g)
    np.testing.assert_allclose(yt, yj, **SMOOTH_TOL)
    np.testing.assert_allclose(dt, dj, **SMOOTH_TOL)


def test_unknown_activation_layer_raises_as_jax_does():
    with pytest.raises(ValueError, match="unknown activation") as want:
        jax_model.build([{"type": "activation_bogus"}], (4,))
    with pytest.raises(ValueError, match="unknown activation") as got:
        model_lib.build([{"type": "activation_bogus"}], (4,), device="cpu")
    assert str(got.value) == str(want.value)


# -- the new layer types in one model ----------------------------------------------

GD = {"learning_rate": 0.05, "gradient_moment": 0.9}
LAYERS = [
    {"type": "conv_tanh", "->": {"n_kernels": 6, "kx": 3, "ky": 3, "padding": (1, 1, 1, 1)},
     "<-": GD},
    {"type": "maxabs_pooling", "->": {"kx": 2, "ky": 2}},
    {"type": "cutter", "->": {"padding": (1, 0, 0, 1)}},
    {"type": "activation_sigmoid"},
    {"type": "stochastic_pooling", "->": {"kx": 2, "ky": 2, "sliding": (1, 1)}},
    {"type": "activation_log"},
    {"type": "softmax", "->": {"output_sample_shape": 5}, "<-": GD},
]


@pytest.fixture(scope="module")
def both_models():
    _seed_both()
    jm = jax_model.build(LAYERS, (10, 10, 2))
    tm = model_lib.build(LAYERS, (10, 10, 2), device="cpu")
    return jm, tm


def test_new_layer_types_build_as_in_jax(both_models):
    jm, tm = both_models
    assert tm.layer_types == jm.layer_types
    assert tm.output_shape == jm.output_shape == (5,)
    assert tm.layer_specs == jm.layer_specs
    assert [s for s in tm.layer_shapes] == [
        (10, 10, 6), (5, 5, 6), (4, 4, 6), (4, 4, 6), (3, 3, 6), (3, 3, 6), (5,)]
    for lj, lt in zip(jm.params, model_lib.params_to_numpy(tm.params)):
        assert lj.keys() == lt.keys()
        for k in lj:
            np.testing.assert_array_equal(lt[k], np.asarray(lj[k]))


def test_new_layer_types_eval_forward_and_gradients_match_jax(both_models):
    jm, tm = both_models
    x = _cotangent((3, 10, 10, 2), 13)
    labels = np.array([0, 3, 4], np.int32)

    def jloss(params):
        logp = jax.nn.log_softmax(jm.apply(params, jnp.asarray(x)))
        return -jnp.mean(logp[jnp.arange(3), labels])

    jl, jg = jax.value_and_grad(jloss)(jm.params)
    params = [{k: w.clone().requires_grad_(True) for k, w in layer.items()}
              for layer in tm.params]
    out = tm.apply(params, torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jm.apply(jm.params, jnp.asarray(x))),
                               rtol=MODEL_FWD_RTOL, atol=1e-6)
    tl = torch.nn.functional.cross_entropy(out, torch.from_numpy(labels).long())
    np.testing.assert_allclose(tl.item(), float(jl), rtol=MODEL_FWD_RTOL)
    leaves = [w for layer in params for w in layer.values()]
    grads = iter(torch.autograd.grad(tl, leaves))
    for lj, lt in zip(jg, params):
        for k in lt:
            np.testing.assert_allclose(next(grads).numpy(), np.asarray(lj[k]),
                                       **MODEL_GRAD_TOL)


def test_new_layer_types_train_forward_draws_from_the_generator(both_models):
    _, tm = both_models
    x = torch.from_numpy(_cotangent((3, 10, 10, 2), 14))
    with pytest.raises(ValueError, match="Generator"):
        tm.apply(tm.params, x, train=True)
    a = tm.apply(tm.params, x, train=True, generator=torch.Generator().manual_seed(1))
    b = tm.apply(tm.params, x, train=True, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and a.shape == (3, 5) and bool(torch.isfinite(a).all())
    probs = tm.predict(tm.params, x)
    torch.testing.assert_close(probs.sum(dim=1), torch.ones(3))


# -- accumulator, zero-filling, resizable FC -----------------------------------------

def test_accumulator_with_a_mask_matches_jax():
    rng = np.random.default_rng(15)
    batches = [rng.standard_normal((5, 2, 3)).astype(np.float32) for _ in range(3)]
    masks = [np.array([1, 1, 0, 1, 0], np.float32), None, np.array([0, 1, 1, 1, 1], np.float32)]
    sj = jax_acc.init(6)
    st = accumulator.init(6, device="cpu")
    for x, m in zip(batches, masks):
        sj = jax_acc.update(sj, jnp.asarray(x), None if m is None else jnp.asarray(m))
        st = accumulator.update(st, torch.from_numpy(x), None if m is None else torch.from_numpy(m))
    for field in ("lo", "hi", "count"):
        np.testing.assert_array_equal(getattr(st, field).numpy(), np.asarray(getattr(sj, field)))
    np.testing.assert_allclose(st.total.numpy(), np.asarray(sj.total), **GRAD_TOL)
    np.testing.assert_allclose(st.mean.numpy(), np.asarray(sj.mean), **GRAD_TOL)
    assert float(st.count) == 3 + 5 + 4


def test_weights_zerofilling_matches_jax():
    mj = jax_zf.make_group_mask(6, 4, 2)
    mt = weights_zerofilling.make_group_mask(6, 4, 2, device="cpu")
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    with pytest.raises(ValueError, match="groups"):
        weights_zerofilling.make_group_mask(5, 4, 2, device="cpu")
    rng = np.random.default_rng(16)
    w = rng.standard_normal((6, 4)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    gw = rng.standard_normal((6, 4)).astype(np.float32)
    gb = rng.standard_normal(4).astype(np.float32)
    hyper = [optimizer.HyperParams(learning_rate=0.1, gradient_moment=0.9, weights_decay=0.01)]
    jhyper = [jax_opt.HyperParams(learning_rate=0.1, gradient_moment=0.9, weights_decay=0.01)]
    masks_j = {0: {"weights": mj}}
    masks_t = {0: {"weights": mt}}
    applied = weights_zerofilling.apply_masks([{"weights": torch.from_numpy(w)}], masks_t)
    np.testing.assert_array_equal(
        applied[0]["weights"].numpy(),
        np.asarray(jax_zf.apply_masks([{"weights": jnp.asarray(w)}], masks_j)[0]["weights"]))
    jp = [{"weights": jnp.asarray(w), "bias": jnp.asarray(b)}]
    jv = [{"weights": jnp.zeros_like(jp[0]["weights"]), "bias": jnp.zeros_like(jp[0]["bias"])}]
    jg = [{"weights": jnp.asarray(gw), "bias": jnp.asarray(gb)}]
    tp = [{"weights": torch.from_numpy(w.copy()), "bias": torch.from_numpy(b.copy())}]
    tv = [{k: torch.zeros_like(t) for k, t in tp[0].items()}]
    tg = [{"weights": torch.from_numpy(gw), "bias": torch.from_numpy(gb)}]
    jupdate = jax_zf.masked_update(jax_opt.update, masks_j)
    tupdate = weights_zerofilling.masked_update(optimizer.update, masks_t)
    for _ in range(2):
        jp, jv = jupdate(jp, jg, jv, jhyper)
        tupdate(tp, tg, tv, hyper)
    for k in ("weights", "bias"):
        np.testing.assert_allclose(tp[0][k].numpy(), np.asarray(jp[0][k]), **GRAD_TOL)
    assert bool((tp[0]["weights"][mt == 0] == 0).all())


@pytest.mark.parametrize("n_output", [7, 3, 5], ids=["grow", "shrink", "same"])
def test_resizable_all2all_matches_jax(n_output):
    rng = np.random.default_rng(17)
    w = rng.standard_normal((4, 5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    _seed_both()
    pj = jax_resizable.resize({"weights": jnp.asarray(w), "bias": jnp.asarray(b)}, n_output)
    pt = resizable_all2all.resize({"weights": torch.from_numpy(w), "bias": torch.from_numpy(b)},
                                  n_output)
    for k in ("weights", "bias"):
        assert pt[k].shape == pj[k].shape
        np.testing.assert_array_equal(pt[k].numpy(), np.asarray(pj[k]))
    x = _cotangent((3, 4), 18)
    np.testing.assert_allclose(
        resizable_all2all.apply(pt, torch.from_numpy(x)).numpy(),
        np.asarray(jax_resizable.apply(pj, jnp.asarray(x))), **GRAD_TOL)


# -- the CIFAR-10 and Wine readers ---------------------------------------------------

def _cifar_tree(root, seed=19):
    """Five ``data_batch_*`` files of 3 images and a ``test_batch`` of 4, in
    the dataset's pickle format (rows of 3072 bytes, channel-major)."""
    rng = np.random.default_rng(seed)
    names = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]
    for name in names:
        n = 4 if name == "test_batch" else 3
        d = {b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
             b"labels": [int(v) for v in rng.integers(0, 10, n)]}
        with open(os.path.join(root, name), "wb") as f:
            pickle.dump(d, f)


def _same_batches(tl, jl, atol=0.0):
    for _ in range(2):
        got, want = list(tl.epoch()), list(jl.epoch())
        assert [s for s, _ in got] == [s for s, _ in want]
        for (_, mt), (_, mj) in zip(got, want):
            for field in ("labels", "mask", "indices"):
                np.testing.assert_array_equal(getattr(mt, field), getattr(mj, field))
            assert mt.data.dtype == mj.data.dtype == np.float32
            np.testing.assert_allclose(mt.data, mj.data, rtol=0, atol=atol)


@pytest.mark.parametrize("normalization", [None, "mean_disp"], ids=["range_u8", "named"])
def test_cifar10_reads_a_pickle_tree_as_jax_does(tmp_path, normalization):
    _cifar_tree(str(tmp_path))
    kw = {} if normalization is None else {"normalization": normalization}
    _seed_both()
    jl = jax_datasets.cifar10(str(tmp_path), minibatch_size=4, **kw)
    tl = datasets.cifar10(str(tmp_path), minibatch_size=4, **kw)
    assert tl.class_lengths == jl.class_lengths == {"train": 15, "test": 4}
    assert tl.sample_shape == (32, 32, 3)
    for split in ("train", "test"):
        np.testing.assert_array_equal(tl.labels[split], jl.labels[split])
    # NHWC from the channel-major rows
    with open(tmp_path / "test_batch", "rb") as f:
        raw = pickle.load(f, encoding="bytes")[b"data"]
    if normalization is None:
        assert tl.normalizer["kind"] == jl.normalizer["kind"] == "range"
        want = raw.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1) / 255.0 - 0.5
        np.testing.assert_allclose(tl.data["test"], want, rtol=0, atol=1e-7)
    # the JAX loader's native u8 gather rounds x/255 - 0.5 one ulp apart
    # from the numpy formula the port uses
    _same_batches(tl, jl, atol=1e-7)


def test_cifar10_without_files_is_the_synthetic_stand_in(tmp_path):
    _seed_both()
    jl = jax_datasets.cifar10(str(tmp_path), n_train=6, n_test=3, minibatch_size=4)
    tl = datasets.cifar10(str(tmp_path), n_train=6, n_test=3, minibatch_size=4)
    for split in ("train", "test"):
        np.testing.assert_array_equal(tl.data[split], jl.data[split])
        np.testing.assert_array_equal(tl.labels[split], jl.labels[split])
    _same_batches(tl, jl)


def test_wine_reads_a_csv_as_jax_does(tmp_path):
    rng = np.random.default_rng(20)
    rows = np.concatenate(
        [rng.integers(1, 4, (12, 1)), np.round(rng.uniform(0, 100, (12, 13)), 2)], axis=1)
    path = tmp_path / "wine.data"
    np.savetxt(path, rows, delimiter=",", fmt="%g")
    _seed_both()
    jl = jax_datasets.wine(str(path), minibatch_size=5)
    tl = datasets.wine(str(path), minibatch_size=5)
    assert tl.class_lengths == jl.class_lengths == {"train": 12}
    np.testing.assert_array_equal(tl.labels["train"], rows[:, 0].astype(np.int32) - 1)
    np.testing.assert_array_equal(tl.data["train"], jl.data["train"])
    _same_batches(tl, jl)


def test_wine_without_a_file_is_the_synthetic_stand_in():
    _seed_both()
    jl = jax_datasets.wine(None)
    tl = datasets.wine(None)
    assert tl.class_lengths == {"train": 178} and tl.sample_shape == (13,)
    np.testing.assert_array_equal(tl.data["train"], jl.data["train"])
    np.testing.assert_array_equal(tl.labels["train"], jl.labels["train"])
    _same_batches(tl, jl)
