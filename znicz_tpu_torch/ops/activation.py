"""Activation functions (port of ``znicz_tpu/ops/activation.py``).

The reference's naming is kept, quirks included:

* ``tanh`` is the scaled LeCun tanh ``1.7159 * tanh(0.6666 x)``;
* ``relu`` is the smooth softplus ``log(1 + exp(x))``; ``strict_relu`` is
  ``max(x, 0)``;
* ``log`` is ``asinh``.
"""

from __future__ import annotations

import torch

TANH_A = 1.7159
TANH_B = 0.6666


def tanh(x: torch.Tensor) -> torch.Tensor:
    return TANH_A * torch.tanh(TANH_B * x)


def relu(x: torch.Tensor) -> torch.Tensor:
    """Reference 'RELU': smooth softplus log(1+exp(x))."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def strict_relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0.0)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


def log(x: torch.Tensor) -> torch.Tensor:
    return torch.asinh(x)


def linear(x: torch.Tensor) -> torch.Tensor:
    return x


ACTIVATIONS = {
    "linear": linear,
    "tanh": tanh,
    "relu": relu,
    "strict_relu": strict_relu,
    "sigmoid": sigmoid,
    "log": log,
}


def get(name: str):
    try:
        return ACTIVATIONS[name]
    except KeyError:
        raise ValueError(
            f"unknown activation {name!r}; known: {sorted(ACTIVATIONS)}"
        ) from None
