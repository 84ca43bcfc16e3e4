"""Fully-connected (All2All) op (port of ``znicz_tpu/ops/all2all.py``).

Weights are ``[n_input, n_output]`` as in the JAX package.  The input is
flattened in NHWC order before the product, so a conv stack's first FC reads
its weights in the same order as the reference.  The product is
``torch.matmul`` (cuBLAS on the card), as the JAX package left it to XLA.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from znicz_tpu_torch.core import device as device_lib, prng
from znicz_tpu_torch.ops import activation as act
from znicz_tpu_torch.ops.filling import fill, to_param


def init_params(
    n_input: int,
    n_output: int,
    *,
    weights_stddev: Optional[float] = None,
    bias_stddev: Optional[float] = None,
    weights_filling: str = "uniform",
    bias_filling: str = "uniform",
    rand_name: str = "default",
    dtype=torch.float32,
    device: device_lib.DeviceLike = None,
) -> Dict[str, torch.Tensor]:
    """FC params from the shared named generator (default stddev
    ``1/sqrt(fan_in)``, the reference heuristic) on ``device`` (None: the
    card, raising without one)."""
    dev = device_lib.resolve(device)
    gen = prng.get(rand_name)
    if weights_stddev is None:
        weights_stddev = 1.0 / np.sqrt(n_input)
    if bias_stddev is None:
        bias_stddev = weights_stddev
    w = fill(gen, (n_input, n_output), weights_filling, weights_stddev)
    b = fill(gen, (n_output,), bias_filling, bias_stddev)
    return {"weights": to_param(w, dev, dtype), "bias": to_param(b, dev, dtype)}


def apply(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,
    *,
    activation: str = "linear",
    include_bias: bool = True,
) -> torch.Tensor:
    """Flatten trailing dims (NHWC order), matmul, bias, activation."""
    n_in = params["weights"].shape[0]
    x = x.reshape(x.shape[0], n_in)
    y = torch.matmul(x, params["weights"])
    if include_bias:
        y = y + params["bias"]
    return act.get(activation)(y).to(x.dtype)


def softmax_apply(
    params: Dict[str, torch.Tensor], x: torch.Tensor, *, include_bias: bool = True
) -> torch.Tensor:
    """All2AllSoftmax: FC followed by a numerically-stable softmax."""
    logits = apply(params, x, activation="linear", include_bias=include_bias)
    return torch.exp(log_softmax(logits))


def log_softmax(logits: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(logits, dim=-1)
