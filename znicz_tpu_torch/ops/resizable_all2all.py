"""Resizable fully-connected layer (port of
``znicz_tpu/ops/resizable_all2all.py``).

An FC layer whose output width changes during an experiment: ``resize``
keeps the trained overlap and draws any new columns from the shared named
numpy stream, as the JAX package does, so the same stream gives the same
new columns in both frameworks.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from znicz_tpu_torch.core import prng
from znicz_tpu_torch.ops import all2all
from znicz_tpu_torch.ops.filling import fill

apply = all2all.apply  # the forward is the ordinary FC
init_params = all2all.init_params


def resize(
    params: Dict[str, torch.Tensor],
    n_output: int,
    *,
    weights_stddev: Optional[float] = None,
    weights_filling: str = "uniform",
    rand_name: str = "default",
) -> Dict[str, torch.Tensor]:
    """Grow or shrink the output dim, keeping the trained overlap."""
    w = params["weights"]
    b = params["bias"]
    n_in, n_old = w.shape
    if n_output == n_old:
        return params
    if n_output < n_old:
        return {"weights": w[:, :n_output], "bias": b[:n_output]}
    gen = prng.get(rand_name)
    if weights_stddev is None:
        weights_stddev = 1.0 / np.sqrt(n_in)
    extra_w = fill(gen, (n_in, n_output - n_old), weights_filling, weights_stddev)
    extra_b = fill(gen, (n_output - n_old,), weights_filling, weights_stddev)
    return {
        "weights": torch.cat([w, torch.from_numpy(extra_w).to(w.device, w.dtype)], dim=1),
        "bias": torch.cat([b, torch.from_numpy(extra_b).to(b.device, b.dtype)]),
    }
