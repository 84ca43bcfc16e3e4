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
        return cls(params=params, velocity=_zeros_like(params), step=0, generator=generator)


def _zeros_like(tree):
    """Zero momentum buffers in the params' lists and dicts (a list of
    layer dicts, or the pipelined LM's ``{"embed", "stages", "head"}``)."""
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_zeros_like(v) for v in tree]
    return torch.zeros_like(tree)
