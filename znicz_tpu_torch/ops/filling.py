"""Shared weight/bias filling (port of ``znicz_tpu/ops/filling.py``).

Draws from the named numpy stream exactly as the JAX package does, so the
same seed gives bit-identical initial weights in both frameworks.
"""

from __future__ import annotations

import numpy as np

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
