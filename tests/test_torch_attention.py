"""The port's attention ops against the JAX package, on the CPU.

The plain flash version (the port's CPU path, and the oracle of its CUDA
kernels) against JAX's ``flash_attention_lse``, whose Pallas kernels run in
interpret mode here as ``tests/test_pallas.py`` runs them (blocks of 16, so
T = 48 spans 3 blocks and T = 37 pads a ragged one; head dim 16, and in
bf16 also head dim 64 at T = 130, the LM's head dim over more than two of
the CUDA kernels' 64-row tiles and 9 of JAX's blocks; and head dims 48 and
96 at T = 130 in both dtypes, which the port zero-pads to the kernels' 64
and 128 in its autograd layer while JAX's blocks span the true head dim,
so the padding's output and gradient slicing and its scale are checked
too): in f32, ``out`` and
``lse`` within rtol/atol 1e-5, and the gradients of ``sum(sin(out)) +
sum(w * lse)`` (the lse cotangent included) within 1e-4; in bf16 (the same
numpy inputs cast to bf16 on both sides), ``out`` and the gradients within
1e-2 of the reference's largest magnitude (about one bf16 ulp of headroom
over the roundings of ``p`` and ``ds`` that the two place differently) and
``lse`` within 1e-5 of it.  Also ``dot_product_attention``,
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


# (T, causal, dtype, head dim); the f32 cases keep their ids from before
# bf16 joined, the head-dim-16 cases theirs from before head dim 64
FLASH_CASES = [
    pytest.param(t, causal, dtype, 16, id=f"{t}-{'causal' if causal else 'full'}"
                 + ("" if dtype == "float32" else "-bf16"))
    for dtype in ("float32", "bfloat16") for causal in (False, True) for t in (48, 37)
] + [
    pytest.param(130, causal, "bfloat16", 64, id=f"130-{'causal' if causal else 'full'}-bf16-d64")
    for causal in (False, True)
] + [  # head dims between the kernels': zero-padded to 64 and 128 in the autograd layer
    pytest.param(130, causal, dtype, d, id=f"130-{'causal' if causal else 'full'}"
                 + ("" if dtype == "float32" else "-bf16") + f"-d{d}")
    for d in (48, 96) for dtype in ("float32", "bfloat16") for causal in (False, True)
]


def _near_max(got, want, tol):
    """Within ``tol`` of the reference's largest magnitude, compared in f32."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (err, float(np.abs(want).max()))


@pytest.mark.parametrize("t,causal,dtype,d", FLASH_CASES)
def test_flash_forward_matches_jax(t, causal, dtype, d):
    q, k, v = _qkv(t, 10 * t, d=d)
    jo, jl = jflash.flash_attention_lse(
        *(jnp.asarray(x, dtype) for x in (q, k, v)), causal=causal, block_q=16, block_k=16
    )
    to, tl = tflash.flash_attention_lse(
        *(torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v)),
        causal=causal, block_q=16, block_k=16,
    )
    assert to.shape == (2, t, 2, d) and tl.shape == (2, t, 2)
    assert str(to.dtype).endswith(dtype) and tl.dtype == torch.float32
    if dtype == "float32":
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
    else:
        _near_max(to.float().numpy(), jo, 1e-2)
        _near_max(tl.numpy(), jl, 1e-5)


@pytest.mark.parametrize("t,causal,dtype,d", FLASH_CASES)
def test_flash_gradients_match_jax(t, causal, dtype, d):
    q, k, v = _qkv(t, 10 * t + 1, d=d)
    w = _np((2, t, 2), 7)

    def jloss(q, k, v):
        out, lse = jflash.flash_attention_lse(q, k, v, causal=causal, block_q=16, block_k=16)
        return jnp.sum(jnp.sin(out.astype(jnp.float32))) + jnp.sum(jnp.asarray(w) * lse)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x, dtype) for x in (q, k, v)))
    xs = [torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True) for x in (q, k, v)]
    out, lse = tflash.flash_attention_lse(*xs, causal=causal, block_q=16, block_k=16)
    got = torch.autograd.grad(torch.sin(out.float()).sum() + (torch.from_numpy(w) * lse).sum(), xs)
    for g, r in zip(got, want):
        assert str(g.dtype).endswith(dtype) and str(r.dtype) == dtype
        if dtype == "float32":
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-4)
        else:
            _near_max(g.float().numpy(), r, 1e-2)


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
