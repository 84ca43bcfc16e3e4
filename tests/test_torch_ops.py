"""The port's ops, evaluators and optimizer against the JAX package's, on the
CPU, in f32 (rtol 1e-5 unless stated).  Inputs are numpy arrays from a seed,
handed to both frameworks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from znicz_tpu.nn import evaluator as jax_ev, optimizer as jax_opt
from znicz_tpu.ops import (
    activation as jax_act,
    all2all as jax_a2a,
    conv as jax_conv,
    pooling as jax_pool,
)
from znicz_tpu_torch.nn import evaluator, optimizer
from znicz_tpu_torch.ops import activation, all2all, conv, pooling

torch.set_float32_matmul_precision("highest")
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

RTOL, ATOL = 1e-5, 1e-6


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("name", sorted(activation.ACTIVATIONS))
def test_activations_match(name):
    x = _rand((64,), seed=1, scale=4.0)
    np.testing.assert_allclose(
        activation.get(name)(torch.from_numpy(x)).numpy(),
        np.asarray(jax_act.get(name)(jnp.asarray(x))),
        rtol=RTOL, atol=ATOL,
    )


def test_relu_is_softplus():
    x = torch.tensor([-30.0, -1.0, 0.0, 1.0, 30.0])
    np.testing.assert_allclose(
        activation.relu(x).numpy(), np.log1p(np.exp(x.numpy())), rtol=RTOL
    )


CONV_CASES = {
    # name: (input shape NHWC, kx, ky, n_kernels, sliding, padding)
    "sym_pad": ((2, 9, 9, 3), 3, 3, 4, (1, 1), (1, 1, 1, 1)),
    "asym_pad": ((2, 8, 7, 3), 3, 3, 4, (1, 1), (2, 0, 1, 1)),
    "stride4_kx_ne_ky": ((2, 23, 19, 3), 7, 5, 6, (4, 4), (0, 0, 0, 0)),
    "stride_sx_ne_sy": ((1, 12, 14, 2), 3, 4, 3, (3, 2), (1, 2, 0, 1)),
    "pad_2tuple": ((2, 6, 8, 2), 3, 3, 3, (1, 1), (1, 2)),
    "same": ((2, 9, 10, 2), 4, 3, 3, (2, 3), "SAME"),
    "valid": ((2, 9, 10, 2), 4, 3, 3, (2, 3), "VALID"),
}


@pytest.mark.parametrize("act_name", ["linear", "relu", "tanh", "strict_relu", "sigmoid"])
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv_matches(case, act_name):
    shape, kx, ky, nk, sliding, padding = CONV_CASES[case]
    x = _rand(shape, seed=2)
    p = {
        "weights": _rand((ky, kx, shape[3], nk), seed=3, scale=0.3),
        "bias": _rand((nk,), seed=4, scale=0.1),
    }
    kw = dict(sliding=sliding, padding=padding, activation=act_name)
    ref = np.asarray(jax_conv.apply(_j(p), jnp.asarray(x), **kw))
    got = conv.apply(_t(p), torch.from_numpy(x), **kw).numpy()
    assert got.shape == ref.shape == conv.output_shape(shape, nk, kx, ky, sliding, padding)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_conv_gradients_match():
    shape, kx, ky, nk, sliding, padding = CONV_CASES["stride_sx_ne_sy"]
    x = _rand(shape, seed=5)
    p = {
        "weights": _rand((ky, kx, shape[3], nk), seed=6, scale=0.3),
        "bias": _rand((nk,), seed=7, scale=0.1),
    }
    kw = dict(sliding=sliding, padding=padding, activation="relu")

    def jloss(p, x):
        return jnp.sum(jnp.sin(jax_conv.apply(p, x, **kw)))

    gp, gx = jax.grad(jloss, argnums=(0, 1))(_j(p), jnp.asarray(x))
    tp = {k: v.requires_grad_(True) for k, v in _t(p).items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    torch.sum(torch.sin(conv.apply(tp, tx, **kw))).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=1e-4, atol=1e-5)
    for k in p:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(gp[k]), rtol=1e-4, atol=1e-5)


def test_conv_space_to_depth_accepted_and_unknown_raises():
    shape, kx, ky, nk, sliding, padding = CONV_CASES["stride4_kx_ne_ky"]
    x = torch.from_numpy(_rand(shape, seed=8))
    p = _t({"weights": _rand((ky, kx, 3, nk), seed=9), "bias": _rand((nk,), seed=10)})
    plain = conv.apply(p, x, sliding=sliding)
    for mode in ("auto", "always"):
        assert torch.equal(conv.apply(p, x, sliding=sliding, space_to_depth=mode), plain)
    with pytest.raises(ValueError, match="space_to_depth"):
        conv.apply(p, x, sliding=sliding, space_to_depth="sometimes")


@pytest.mark.parametrize("act_name", ["linear", "relu", "tanh"])
def test_all2all_on_nhwc_input(act_name):
    x = _rand((3, 4, 5, 6), seed=11)
    p = {"weights": _rand((120, 7), seed=12, scale=0.1), "bias": _rand((7,), seed=13)}
    np.testing.assert_allclose(
        all2all.apply(_t(p), torch.from_numpy(x), activation=act_name).numpy(),
        np.asarray(jax_a2a.apply(_j(p), jnp.asarray(x), activation=act_name)),
        rtol=RTOL, atol=ATOL,
    )


def test_all2all_init_matches_jax_stream():
    from znicz_tpu.core import prng as jprng
    from znicz_tpu_torch.core import prng as tprng

    for reg in (jprng, tprng):
        reg.reset()
        reg.seed_all(3)
    jp = jax_a2a.init_params(10, 4, weights_filling="gaussian", weights_stddev=0.2)
    tp = all2all.init_params(
        10, 4, weights_filling="gaussian", weights_stddev=0.2, device="cpu"
    )
    for k in jp:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))


POOL_CASES = [((2, 9, 9, 3), 3, 3, (2, 2)), ((1, 7, 10, 2), 2, 3, None), ((2, 8, 6, 4), 3, 2, (1, 2))]


@pytest.mark.parametrize("kind", ["max", "avg"])
@pytest.mark.parametrize("case", range(len(POOL_CASES)))
def test_pooling_matches(kind, case):
    shape, kx, ky, sliding = POOL_CASES[case]
    x = _rand(shape, seed=14 + case)
    ref = np.asarray(getattr(jax_pool, f"{kind}_pool")(jnp.asarray(x), kx, ky, sliding))
    got = getattr(pooling, f"{kind}_pool")(torch.from_numpy(x), kx, ky, sliding).numpy()
    assert got.shape == ref.shape == pooling.output_shape(shape, kx, ky, sliding)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def _check_metrics(got, ref):
    assert set(got) == set(ref) - {"confusion"}
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("masked", [False, True])
def test_softmax_evaluator_matches(masked):
    logits = _rand((9, 5), seed=20, scale=3.0)
    labels = np.random.default_rng(21).integers(0, 5, 9).astype(np.int32)
    mask = np.array([1] * 6 + [0] * 3, np.float32) if masked else None
    ref = jax_ev.softmax(
        jnp.asarray(logits), jnp.asarray(labels),
        mask=None if mask is None else jnp.asarray(mask),
    )
    got = evaluator.softmax(
        torch.from_numpy(logits), torch.from_numpy(labels),
        mask=None if mask is None else torch.from_numpy(mask),
    )
    _check_metrics(got, ref)
    assert got["n_err"].dtype == torch.int32


@pytest.mark.parametrize("masked", [False, True])
def test_mse_evaluator_matches(masked):
    out = _rand((6, 12), seed=22)
    target = _rand((6, 2, 3, 2), seed=23)
    mask = np.array([1, 1, 0, 1, 0, 1], np.float32) if masked else None
    ref = jax_ev.mse(
        jnp.asarray(out), jnp.asarray(target),
        mask=None if mask is None else jnp.asarray(mask),
    )
    got = evaluator.mse(
        torch.from_numpy(out), torch.from_numpy(target),
        mask=None if mask is None else torch.from_numpy(mask),
    )
    _check_metrics(got, ref)


ALEXNET_GD = {
    "learning_rate": 0.01,
    "gradient_moment": 0.9,
    "weights_decay": 0.0005,
    "learning_rate_bias": 0.02,
    "weights_decay_bias": 0.0,
}


@pytest.mark.parametrize(
    "hyper",
    [
        ALEXNET_GD,
        dict(ALEXNET_GD, l1_vs_l2=0.3),
        dict(learning_rate=0.05, weights_decay=0.01, l1_vs_l2=1.0, gradient_moment_bias=0.5),
    ],
    ids=["alexnet", "alexnet_l1_mix", "no_moment_pure_l1"],
)
def test_optimizer_step_matches(hyper):
    shapes = [{"weights": (3, 3, 2, 4), "bias": (4,)}, {}, {"weights": (36, 5), "bias": (5,)}]
    rng = np.random.default_rng(30)

    def tree(scale):
        return [
            {k: (scale * rng.standard_normal(s)).astype(np.float32) for k, s in layer.items()}
            for layer in shapes
        ]

    params, grads, velocity = tree(1.0), tree(0.1), tree(0.01)
    hp_j = [jax_opt.HyperParams(**hyper)] * len(shapes)
    hp_t = [optimizer.HyperParams(**hyper)] * len(shapes)
    new_p, new_v = jax_opt.update(
        [_j(p) for p in params], [_j(g) for g in grads], [_j(v) for v in velocity], hp_j
    )
    tp, tv = [_t(p) for p in params], [_t(v) for v in velocity]
    optimizer.update(tp, [_t(g) for g in grads], tv, hp_t)
    for layer_j, layer_t in zip(list(new_p) + list(new_v), tp + tv):
        for k in layer_j:
            np.testing.assert_allclose(
                layer_t[k].numpy(), np.asarray(layer_j[k]), rtol=RTOL, atol=1e-7
            )
