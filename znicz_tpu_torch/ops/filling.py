"""Shared weight/bias filling (port of ``znicz_tpu/ops/filling.py``).

Draws from the named numpy stream exactly as the JAX package does, so the
same seed gives bit-identical initial weights in both frameworks.
"""

from __future__ import annotations

import numpy as np
import torch

from znicz_tpu_torch.core.prng import RandomGenerator

FILLINGS = ("uniform", "gaussian", "constant")


def fill(
    gen: RandomGenerator, shape, filling: str, stddev: float
) -> np.ndarray:
    """Draw one parameter tensor; exactly one generator draw for the random
    modes so deterministic PRNG streams stay aligned across configs."""
    if filling == "uniform":
        return gen.uniform(shape, -stddev, stddev)
    if filling == "gaussian":
        return gen.normal(shape, 0.0, stddev)
    if filling == "constant":
        return np.full(shape, stddev, np.float32)
    raise ValueError(
        f"unknown filling {filling!r}; expected one of {FILLINGS}"
    )


def to_param(arr: np.ndarray, device, dtype) -> torch.Tensor:
    """A float32 draw as a tensor on ``device`` in ``dtype`` (a torch dtype,
    or a name or numpy dtype such as "bfloat16" or ``np.float16``), cast
    once, as the JAX package's ``jnp.asarray(w, dtype)``."""
    if not isinstance(dtype, torch.dtype):
        name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
        dtype = getattr(torch, name, None)
        if not isinstance(dtype, torch.dtype):
            raise ValueError(f"dtype {name!r} is not a torch dtype")
    return torch.from_numpy(arr).to(device=device, dtype=dtype)
