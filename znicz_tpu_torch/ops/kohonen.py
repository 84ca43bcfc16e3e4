"""Kohonen self-organizing map: winner-take-all forward and the batch-SOM
rule (port of ``znicz_tpu/ops/kohonen.py``).

The learning rule is the trainer; there is no gradient.  These are the
plain PyTorch ops: the fused winner + neighbourhood accumulation that the
JAX package runs as a Pallas kernel is ``ops/kernels/kohonen.py``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from znicz_tpu_torch.core import device as device_lib, prng
from znicz_tpu_torch.ops.filling import fill


def init_params(
    sx: int,
    sy: int,
    n_input: int,
    *,
    weights_stddev: float | None = None,
    weights_filling: str = "uniform",
    rand_name: str = "default",
    dtype=torch.float32,
    device: device_lib.DeviceLike = None,
) -> Dict[str, torch.Tensor]:
    """``{"weights": [sx*sy, n_input]}`` drawn from the named numpy stream as
    the JAX package draws it (uniform in ``±1/sqrt(n_input)`` by default),
    on ``device`` (None: the card, raising without one)."""
    dev = device_lib.resolve(device)
    gen = prng.get(rand_name)
    if weights_stddev is None:
        weights_stddev = 1.0 / np.sqrt(n_input)
    w = fill(gen, (sx * sy, n_input), weights_filling, weights_stddev)
    return {"weights": torch.as_tensor(w, dtype=dtype, device=dev)}


def grid_coords(sx: int, sy: int, *, device: device_lib.DeviceLike = None) -> torch.Tensor:
    """``[sx*sy, 2]`` float32 map-grid coordinates ``(x, y)``, row-major."""
    dev = device_lib.resolve(device)
    ys, xs = torch.meshgrid(torch.arange(sy), torch.arange(sx), indexing="ij")
    return torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=1).to(dev, torch.float32)


def winners(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Index of the closest map unit per sample, ``[B]`` int32:
    ``argmin ||x - w||^2 == argmax (x.w - ||w||^2 / 2)``, first index on
    ties."""
    w = params["weights"]
    scores = x @ w.T - 0.5 * torch.sum(w * w, dim=1)[None, :]
    return torch.argmax(scores, dim=1).to(torch.int32)


def two_sigma_sq(sigma) -> float:
    """``2 sigma^2`` in float32, as the jitted step computes it."""
    s = np.float32(sigma)
    return float(np.float32(2.0) * (s * s))


def train_step(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,
    coords: torch.Tensor,
    *,
    learning_rate,
    sigma,
    mask: torch.Tensor | None = None,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """One batch-SOM update, the plain twin; returns (new params, winners).

    With ``h_j(b) = exp(-d(j, u(b))^2 / (2 sigma^2))`` every unit relaxes
    toward the h-weighted mean of the samples:
    ``w_j <- w_j + lr (sum_b h_j(b) x_b / sum_b h_j(b) - w_j)``; units with
    no neighbourhood mass stay put.  ``learning_rate`` and ``sigma`` are
    host scalars, taken in float32."""
    w = params["weights"]
    win = winners(params, x)
    d2 = torch.sum(torch.square(coords[None, :, :] - coords[win.long()][:, None, :]), dim=-1)
    h = torch.exp(-d2 / two_sigma_sq(sigma))  # [B, M]
    if mask is not None:  # padded rows of a static batch get zero weight
        h = h * mask[:, None]
    num = h.T @ x  # [M, F]
    denom = torch.sum(h, dim=0)[:, None]  # [M, 1]
    target = num / torch.clamp_min(denom, 1e-12)
    lr = float(np.float32(learning_rate))
    delta = torch.where(denom > 1e-8, lr * (target - w), 0.0)
    return {"weights": w + delta}, win


def decay_schedule(
    step: int, total_steps: int, *, lr0=0.1, lr1=0.01, sigma0=None, sigma1=1.0, sx=8, sy=8
) -> Tuple[np.float32, np.float32]:
    """The time-decaying lr and neighbourhood radius of step ``step``, on
    the host in float32 as the jitted step computes them:
    ``frac = clip(step / max(total, 1), 0, 1)``, ``lr = lr0 (lr1/lr0)^frac``,
    ``sigma = sigma0 (sigma1/sigma0)^frac`` (``sigma0`` defaults to
    ``max(sx, sy) / 2``).  Two details make it bit-exact: the jitted step
    divides by a compile-time constant, which XLA turns into a product with
    its float32 reciprocal, and the powers are taken on 0-d CPU tensors,
    whose ``pow`` is libm's ``powf``, as in XLA's CPU backend (numpy's
    vectorized float32 ``power`` rounds differently)."""
    if sigma0 is None:
        sigma0 = max(sx, sy) / 2.0

    def f32(v):
        return torch.tensor(np.float32(v), dtype=torch.float32)

    recip = f32(1.0) / f32(max(total_steps, 1))
    frac = torch.clamp(f32(step) * recip, 0.0, 1.0)
    lr = f32(lr0) * torch.pow(f32(lr1 / lr0), frac)
    sigma = f32(sigma0) * torch.pow(f32(sigma1 / sigma0), frac)
    return np.float32(lr.item()), np.float32(sigma.item())
