"""Bernoulli-Bernoulli restricted Boltzmann machine with CD-k (port of
``znicz_tpu/ops/rbm.py``).

The learning rule is a custom update, not a gradient.  These are the plain
PyTorch ops; the fused CD-k chain that the JAX package runs as a Pallas
kernel is ``ops/kernels/rbm.py``.  Sampling here draws from a
``torch.Generator``, so its bits are not JAX's threefry bits.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from znicz_tpu_torch.core import device as device_lib, prng
from znicz_tpu_torch.ops.filling import fill


def init_params(
    n_visible: int,
    n_hidden: int,
    *,
    weights_stddev: float | None = None,
    weights_filling: str = "gaussian",
    rand_name: str = "default",
    dtype=torch.float32,
    device: device_lib.DeviceLike = None,
) -> Dict[str, torch.Tensor]:
    """``{"weights": [V, H], "vbias": [V], "hbias": [H]}``, the weights drawn
    from the named numpy stream as the JAX package draws them (gaussian,
    stddev ``1/sqrt(V)`` by default), the biases zero, on ``device`` (None:
    the card, raising without one)."""
    dev = device_lib.resolve(device)
    gen = prng.get(rand_name)
    if weights_stddev is None:
        weights_stddev = 1.0 / np.sqrt(n_visible)
    w = fill(gen, (n_visible, n_hidden), weights_filling, weights_stddev)
    return {
        "weights": torch.as_tensor(w, dtype=dtype, device=dev),
        "vbias": torch.zeros((n_visible,), dtype=dtype, device=dev),
        "hbias": torch.zeros((n_hidden,), dtype=dtype, device=dev),
    }


def hidden_probs(params, v):
    return torch.sigmoid(v @ params["weights"] + params["hbias"])


def visible_probs(params, h):
    return torch.sigmoid(h @ params["weights"].T + params["vbias"])


def sample(generator: torch.Generator, probs: torch.Tensor) -> torch.Tensor:
    """Bernoulli draws ``u < p`` with ``u`` uniform from ``generator``."""
    u = torch.rand(probs.shape, generator=generator, device=probs.device, dtype=probs.dtype)
    return (u < probs).to(probs.dtype)


def cd_step(
    params: Dict[str, torch.Tensor],
    v0: torch.Tensor,
    generator: torch.Generator,
    *,
    learning_rate: float,
    cd_k: int = 1,
    mask: torch.Tensor | None = None,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """One CD-k update, the plain twin; returns (new params, reconstruction
    error).  ``mask`` ([B] float) zero-weights padded rows."""
    if mask is None:
        mask = torch.ones((v0.shape[0],), dtype=v0.dtype, device=v0.device)
    n_valid = torch.clamp_min(torch.sum(mask), 1.0)
    h0_probs = hidden_probs(params, v0)
    h = sample(generator, h0_probs)
    for _ in range(cd_k):
        vk_probs = visible_probs(params, h)
        v = sample(generator, vk_probs)
        hk_probs = hidden_probs(params, v)
        h = sample(generator, hk_probs)
    lr = float(np.float32(learning_rate)) / n_valid
    m = mask[:, None]
    new = {
        "weights": params["weights"]
        + lr * ((v0 * m).T @ h0_probs - (vk_probs * m).T @ hk_probs),
        "vbias": params["vbias"] + lr * torch.sum((v0 - vk_probs) * m, dim=0),
        "hbias": params["hbias"] + lr * torch.sum((h0_probs - hk_probs) * m, dim=0),
    }
    recon_err = torch.sum(torch.mean(torch.square(v0 - vk_probs), dim=1) * mask) / n_valid
    return new, recon_err
