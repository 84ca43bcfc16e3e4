"""Train state (port of ``znicz_tpu/nn/train_state.py``).

The JAX package keeps an immutable pytree that its jitted step returns anew;
here the state is one mutable object whose tensors the step updates in
place.  ``generator`` takes the place of the JAX state's ``key``: it draws
the step's device randomness (dropout masks).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import torch


@dataclass
class TrainState:
    params: List[Dict[str, torch.Tensor]]
    velocity: List[Dict[str, torch.Tensor]]  # momentum buffers
    step: int
    generator: torch.Generator

    @classmethod
    def create(cls, params, generator: torch.Generator) -> "TrainState":
        velocity = [
            {k: torch.zeros_like(w) for k, w in layer.items()}
            for layer in params
        ]
        return cls(params=params, velocity=velocity, step=0, generator=generator)
