"""Local response normalization across channels, and layer normalization
(port of ``znicz_tpu/ops/normalization.py``).  LRN::

    y_c = x_c / (k + alpha * sum_{c' in window(c)} x_{c'}^2) ** beta

over the trailing (channel) axis of an NHWC tensor, window ``n//2`` below
and ``n - 1 - n//2`` above.

In the JAX package ``impl`` picks the XLA composition or the Pallas kernel;
both compute the same function.  Here a CUDA tensor always goes to the
hand-written Hopper kernel pair (``ops/kernels/lrn.py``) and a CPU tensor to
its plain PyTorch version, so ``"xla"`` and ``"pallas"`` are accepted (JAX
layer specs load unchanged) and select nothing.
"""

from __future__ import annotations

import torch

from znicz_tpu_torch.ops.kernels import lrn as lrn_kernel

# znicz defaults (AlexNet-style).
DEFAULT_ALPHA = 1e-4
DEFAULT_BETA = 0.75
DEFAULT_K = 2.0
DEFAULT_N = 5
IMPLS = ("xla", "pallas")


def lrn(
    x: torch.Tensor,
    *,
    alpha: float = DEFAULT_ALPHA,
    beta: float = DEFAULT_BETA,
    k: float = DEFAULT_K,
    n: int = DEFAULT_N,
    impl: str = "xla",
) -> torch.Tensor:
    """Differentiable LRN: the kernel pair on the card, its plain version
    on the CPU."""
    if impl not in IMPLS:
        raise ValueError(f"unknown lrn impl {impl!r}; known: {IMPLS}")
    return lrn_kernel.lrn(x.contiguous(), alpha, beta, k, n)


def layer_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    *,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Layer normalization over the trailing feature axis, with the
    population variance (``jnp.var``, ddof 0), then ``y * scale + bias``."""
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * scale + bias
