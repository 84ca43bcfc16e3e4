"""Dropout (port of ``znicz_tpu/ops/dropout.py``).

Inverted dropout: kept activations are scaled by ``1/keep`` so eval is the
identity.  The keep mask is a Bernoulli draw from a ``torch.Generator``; it
cannot equal the JAX package's threefry mask from the same seed, so the two
frameworks agree in distribution, not mask for mask.  Under data
parallelism the mask is drawn for the global batch and the rank takes its
rows (:func:`~znicz_tpu_torch.parallel.data_parallel.batch_rand`), so R
ranks draw what one process draws.
"""

from __future__ import annotations

from typing import Optional

import torch

from znicz_tpu_torch.parallel.data_parallel import batch_rand


def dropout(
    x: torch.Tensor,
    *,
    dropout_ratio: float,
    generator: Optional[torch.Generator] = None,
    train: bool = True,
) -> torch.Tensor:
    if not train or dropout_ratio <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout(train=True) needs a torch.Generator")
    keep = 1.0 - dropout_ratio
    mask = batch_rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))
