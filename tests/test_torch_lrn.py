"""The port's LRN (znicz_tpu_torch) against the JAX package's, on the CPU.

On the CPU the port's ``lrn`` runs the plain versions of the Hopper kernel
pair (``lrn_reference`` forward, ``lrn_bwd_reference`` as the autograd
backward).  They are held against the JAX package's Pallas kernel, run in
interpret mode as tests/test_pallas.py runs it, and against its XLA
composition, with that file's tolerances: rtol 1e-5 / atol 1e-6 forward,
1e-4 / 1e-5 gradient, 2e-2 for bf16.  The kernels themselves are compared
with these plain versions on the card by tests/test_torch_kernels.py and
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from znicz_tpu.ops import normalization as jax_norm
from znicz_tpu_torch.ops import normalization
from znicz_tpu_torch.ops.kernels import lrn as lrn_kernel

torch.set_float32_matmul_precision("highest")
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

DEFAULTS = dict(alpha=1e-4, beta=0.75, k=2.0, n=5)
CASES = {
    "default": ((2, 7, 7, 96), {}),
    "n3_beta05": ((4, 3, 3, 64), dict(alpha=2e-4, beta=0.5, k=1.0, n=3)),
    "even_n4": ((2, 4, 4, 32), dict(alpha=1e-3, beta=0.6, k=1.5, n=4)),
    "rows_not_tile_multiple": ((2, 3, 3, 128), {}),
    "beta025": ((3, 2, 5, 40), dict(alpha=5e-3, beta=0.25, k=1.0, n=5)),
    "beta1": ((3, 2, 5, 40), dict(alpha=5e-3, beta=1.0, k=1.0, n=3)),
}


def _x(shape, seed):
    # scaled up so the window sum moves s well away from k
    return (3.0 * np.random.default_rng(seed).standard_normal(shape)).astype(
        np.float32
    )


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case, impl):
    shape, kw = CASES[case]
    x = _x(shape, seed=len(case))
    ref = np.asarray(jax_norm.lrn(jnp.asarray(x), impl=impl, **kw))
    got = normalization.lrn(torch.from_numpy(x), **kw).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_gradient_matches_jax(case, impl):
    shape, kw = CASES[case]
    x = _x(shape, seed=len(case) + 100)
    g_ref = jax.grad(
        lambda v: jnp.sum(jnp.sin(jax_norm.lrn(v, impl=impl, **kw)))
    )(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    torch.sum(torch.sin(normalization.lrn(xt, **kw))).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_ref), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", ["default", "even_n4"])
def test_bwd_reference_is_the_jax_vjp(case):
    """The plain backward alone, on a random cotangent, against the JAX
    Pallas kernel's hand-written backward."""
    shape, kw = CASES[case]
    x = _x(shape, seed=7)
    g = np.random.default_rng(8).standard_normal(shape).astype(np.float32)
    _, vjp = jax.vjp(lambda v: jax_norm.lrn(v, impl="pallas", **kw), jnp.asarray(x))
    (dx_ref,) = vjp(jnp.asarray(g))
    full = {**DEFAULTS, **kw}
    dx = lrn_kernel.lrn_bwd_reference(
        torch.from_numpy(x), torch.from_numpy(g),
        full["alpha"], full["beta"], full["k"], full["n"],
    )
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_ref), rtol=1e-4, atol=1e-5)


def test_bf16_matches_jax_pallas():
    x = _x((2, 4, 4, 96), seed=5)
    ref = jax_norm.lrn(jnp.asarray(x).astype(jnp.bfloat16), impl="pallas")
    got = normalization.lrn(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(ref.astype(jnp.float32)), rtol=2e-2, atol=2e-2
    )


def test_non_contiguous_input_is_made_contiguous():
    x = _x((2, 5, 5, 48), seed=9)
    xt = torch.from_numpy(x).permute(0, 2, 1, 3)  # a strided view
    ref = np.asarray(jax_norm.lrn(jnp.asarray(x.transpose(0, 2, 1, 3)), impl="pallas"))
    np.testing.assert_allclose(normalization.lrn(xt).numpy(), ref, rtol=1e-5, atol=1e-6)


def test_unknown_impl_raises():
    with pytest.raises(ValueError, match="unknown lrn impl"):
        normalization.lrn(torch.zeros(1, 1, 1, 8), impl="cudnn")


def test_kernel_paths_raise_off_the_card():
    """A tensor that is not on the CPU never falls back to the plain
    version, and the kernel wrappers refuse anything but CUDA tensors."""
    x = torch.zeros(2, 3, 3, 16)
    before = (lrn_kernel.lrn_forward.launches, lrn_kernel.lrn_backward.launches)
    with pytest.raises(ValueError, match="CUDA"):
        lrn_kernel.lrn_forward(x.to("meta"), 1e-4, 0.75, 2.0, 5)
    with pytest.raises(ValueError, match="CUDA"):
        lrn_kernel.lrn_backward(x.to("meta"), x.to("meta"), 1e-4, 0.75, 2.0, 5)
    with pytest.raises(ValueError, match="CUDA"):
        lrn_kernel.lrn_backward(x.to("meta"), x, 1e-4, 0.75, 2.0, 5)
    # the CPU path counts no launches
    normalization.lrn(x)
    assert (lrn_kernel.lrn_forward.launches, lrn_kernel.lrn_backward.launches) == before

