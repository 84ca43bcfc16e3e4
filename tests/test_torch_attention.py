"""The port's attention ops against the JAX package, on the CPU.

The plain flash version (the port's CPU path, and the oracle of its CUDA
kernels) against JAX's ``flash_attention_lse``, whose Pallas kernels run in
interpret mode here as ``tests/test_pallas.py`` runs them (blocks of 16, so
T = 48 spans 3 blocks and T = 37 pads a ragged one): ``out`` and ``lse``
within rtol/atol 1e-5, and the gradients of ``sum(sin(out)) + sum(w * lse)``
(the lse cotangent included) within 1e-4.  Also ``dot_product_attention``,
``mha`` (params drawn equal exactly from one seed) and ``layer_norm``.
Inputs are made with numpy from a seed and handed to both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from znicz_tpu.core import prng as jprng
from znicz_tpu.ops import attention as jatt, normalization as jnorm
from znicz_tpu.ops.pallas import attention as jflash
from znicz_tpu_torch.core import prng as tprng
from znicz_tpu_torch.ops import attention as tatt, normalization as tnorm
from znicz_tpu_torch.ops.kernels import attention as tflash

torch.set_float32_matmul_precision("highest")
torch.backends.cuda.matmul.allow_tf32 = False


def _np(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _qkv(t, seed, b=2, h=2, d=16):
    return [_np((b, t, h, d), seed + i) for i in range(3)]


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("t", [48, 37])
def test_flash_forward_matches_jax(causal, t):
    q, k, v = _qkv(t, 10 * t)
    jo, jl = jflash.flash_attention_lse(
        *(jnp.asarray(x) for x in (q, k, v)), causal=causal, block_q=16, block_k=16
    )
    to, tl = tflash.flash_attention_lse(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal, block_q=16, block_k=16
    )
    assert to.shape == (2, t, 2, 16) and tl.shape == (2, t, 2)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("t", [48, 37])
def test_flash_gradients_match_jax(causal, t):
    q, k, v = _qkv(t, 10 * t + 1)
    w = _np((2, t, 2), 7)

    def jloss(q, k, v):
        out, lse = jflash.flash_attention_lse(q, k, v, causal=causal, block_q=16, block_k=16)
        return jnp.sum(jnp.sin(out)) + jnp.sum(jnp.asarray(w) * lse)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    xs = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out, lse = tflash.flash_attention_lse(*xs, causal=causal, block_q=16, block_k=16)
    got = torch.autograd.grad(torch.sin(out).sum() + (torch.from_numpy(w) * lse).sum(), xs)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-2)], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_dot_product_attention_matches_jax(causal, dtype, tol):
    q = _np((2, 5, 3, 8), 1)  # Tq = 5 against Tk = 7: the causal mask's offset
    k, v = _np((2, 7, 3, 8), 2), _np((2, 7, 3, 8), 3)
    want = jatt.dot_product_attention(
        *(jnp.asarray(x, dtype) for x in (q, k, v)), causal=causal
    )
    got = tatt.dot_product_attention(
        *(torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v)), causal=causal
    )
    assert str(got.dtype).endswith(dtype)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol
    )


def _seed_both(seed):
    for reg in (jprng, tprng):
        reg.reset()
        reg.seed_all(seed)


def test_init_mha_params_equal_exactly():
    _seed_both(4)
    jp = jatt.init_mha_params(32, 4)
    tp = tatt.init_mha_params(32, 4, device="cpu")
    assert list(tp) == list(jp) == ["wq", "wk", "wv", "wo"]
    for name in jp:
        assert tp[name].dtype == torch.float32
        np.testing.assert_array_equal(tp[name].numpy(), np.asarray(jp[name]))
    tprng.reset()


@pytest.mark.parametrize("fn", ["dot", "flash"])
def test_mha_matches_jax(fn):
    _seed_both(5)
    jp = jatt.init_mha_params(32, 4)
    tp = tatt.init_mha_params(32, 4, device="cpu")
    tprng.reset()
    x = _np((2, 24, 32), 9)
    if fn == "dot":
        jfn, tfn = jatt.dot_product_attention, tatt.dot_product_attention
    else:
        def jfn(q, k, v, causal):
            return jflash.flash_attention(q, k, v, causal=causal, block_q=8, block_k=8)

        tfn = tflash.flash_attention
    want = jatt.mha(jp, jnp.asarray(x), n_heads=4, causal=True, attention_fn=jfn)
    got = tatt.mha(tp, torch.from_numpy(x), n_heads=4, causal=True, attention_fn=tfn)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_layer_norm_matches_jax():
    x = _np((3, 5, 32), 11, scale=3.0) + 2.0  # a mean and variance far from 0, 1
    scale, bias = _np((32,), 12), _np((32,), 13)
    want = jnorm.layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    got = tnorm.layer_norm(*(torch.from_numpy(a) for a in (x, scale, bias)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # the population variance, as jnp.var: an unbiased one would miss this
    xs = torch.from_numpy(x)
    ones, zeros = torch.ones(32), torch.zeros(32)
    y = tnorm.layer_norm(xs, ones, zeros, eps=0.0)
    np.testing.assert_allclose(y.var(dim=-1, unbiased=False).numpy(), 1.0, rtol=1e-4)
