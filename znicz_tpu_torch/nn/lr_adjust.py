"""Learning-rate schedules (port of ``znicz_tpu/nn/lr_adjust.py``,
framework-free host code).

Step/exponential/inverse decay policies.  A policy is a pure
``f(base_lr, step) -> lr`` callable that the workflow evaluates on the host
each step.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

Policy = Callable[[float, int], float]


def constant() -> Policy:
    return lambda base_lr, step: base_lr


def step_decay(step_size: int, gamma: float = 0.1) -> Policy:
    """lr = base * gamma^(step // step_size) — the reference's StepExp."""
    return lambda base_lr, step: base_lr * gamma ** (step // step_size)


def exp_decay(gamma: float) -> Policy:
    """lr = base * gamma^step."""
    return lambda base_lr, step: base_lr * gamma**step


def inv_decay(gamma: float, power: float = 1.0) -> Policy:
    """lr = base * (1 + gamma*step)^-power — the reference's InvAdjustPolicy."""
    return lambda base_lr, step: base_lr * (1.0 + gamma * step) ** -power


def arbitrary(points) -> Policy:
    """Piecewise-constant from [(step_threshold, lr_multiplier), ...]
    (the reference's ArbitraryStepPolicy)."""
    pts = sorted(points)

    def f(base_lr: float, step: int) -> float:
        mult = 1.0
        for threshold, m in pts:
            if step >= threshold:
                mult = m
        return base_lr * mult

    return f


def linear_warmup_cosine(warmup: int, total: int, floor: float = 0.0) -> Policy:
    """Warmup + cosine decay (not in the reference)."""

    def f(base_lr: float, step: int) -> float:
        if step < warmup:
            return base_lr * (step + 1) / max(warmup, 1)
        frac = min(1.0, (step - warmup) / max(total - warmup, 1))
        return floor + (base_lr - floor) * 0.5 * (1 + math.cos(math.pi * frac))

    return f


_NAMED: Dict[str, Callable[..., Policy]] = {
    "constant": constant,
    "step": step_decay,
    "exp": exp_decay,
    "inv": inv_decay,
    "arbitrary": arbitrary,
    "warmup_cosine": linear_warmup_cosine,
}


def get(name: str, **kwargs) -> Policy:
    """Build a named policy (config-file friendly)."""
    try:
        return _NAMED[name](**kwargs)
    except KeyError:
        raise ValueError(
            f"unknown lr policy {name!r}; have {sorted(_NAMED)}"
        ) from None
