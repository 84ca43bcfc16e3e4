"""Deconvolution (transposed convolution) and depooling: the autoencoder
path (port of ``znicz_tpu/ops/deconv.py``).

Deconv is the exact adjoint of :func:`znicz_tpu_torch.ops.conv.apply` with
the same weights, ``sliding`` and ``padding``, so an autoencoder's decoder
mirrors its encoder.  It is ``F.conv_transpose2d`` (cuDNN on the card) with
no padding, on the NCHW view of NHWC memory with the HWIO weights viewed as
``[K, C, ky, kx]``, then a crop of rows ``[top, top + H)`` and columns
``[left, left + W)`` of that full output, zero-filled past its edge: the
function the JAX package computes as a dilated stride-1 convolution
through XLA (no Pallas kernel).  Gradients are autograd.  Depooling
scatters values back to the offsets that
:func:`znicz_tpu_torch.ops.pooling.max_pool_with_offset` recorded, or
repeats them (nearest-neighbour upsampling).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from znicz_tpu_torch.core import device as device_lib, prng
from znicz_tpu_torch.ops import activation as act
from znicz_tpu_torch.ops.filling import fill, to_param


def init_params(
    n_channels: int,
    n_kernels: int,
    kx: int,
    ky: int,
    *,
    weights_stddev: Optional[float] = None,
    weights_filling: str = "uniform",
    rand_name: str = "default",
    dtype=torch.float32,
    device: device_lib.DeviceLike = None,
) -> Dict[str, torch.Tensor]:
    """Deconv weights in the conv layout ``[ky, kx, n_channels, n_kernels]``:
    ``n_kernels`` is the deconv's input channel count (the mirrored conv's
    kernels), ``n_channels`` its output's, so the fan-in is
    ``kx * ky * n_kernels``.  No bias, as in the reference; one draw from
    the named stream."""
    dev = device_lib.resolve(device)
    gen = prng.get(rand_name)
    if weights_stddev is None:
        weights_stddev = 1.0 / np.sqrt(kx * ky * n_kernels)
    w = fill(gen, (ky, kx, n_channels, n_kernels), weights_filling, weights_stddev)
    return {"weights": to_param(w, dev, dtype)}


def _pads(padding) -> Tuple[int, int, int, int]:
    """(left, top, right, bottom); a string padding is refused, as the JAX
    package refuses it."""
    if isinstance(padding, str):
        raise ValueError("deconv needs explicit reference-style padding")
    if len(padding) == 2:
        return padding[0], padding[1], padding[0], padding[1]
    left, top, right, bottom = padding
    return left, top, right, bottom


def output_shape(
    in_shape: Tuple[int, ...],
    n_channels: int,
    kx: int,
    ky: int,
    sliding: Sequence[int] = (1, 1),
    padding=(0, 0, 0, 0),
) -> Tuple[int, ...]:
    """``(N, H, W, n_channels)``: the minimal exact inverse of the mirrored
    conv, for an NHWC input of ``in_shape``."""
    left, top, right, bottom = _pads(padding)
    n, oh, ow, _ = in_shape
    return (
        n,
        (oh - 1) * sliding[1] + ky - top - bottom,
        (ow - 1) * sliding[0] + kx - left - right,
        n_channels,
    )


def apply(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,
    *,
    sliding: Sequence[int] = (1, 1),
    padding=(0, 0, 0, 0),
    output_size: Optional[Tuple[int, int]] = None,
    activation: str = "linear",
) -> torch.Tensor:
    """Transposed conv, NHWC in and out: the adjoint of ``conv.apply`` with
    the same params, ``sliding`` (sx, sy) and ``padding``.  ``output_size``
    is the reconstructed (H, W); omitted, the minimal exact inverse."""
    w = params["weights"]  # [ky, kx, C, K]
    ky, kx = int(w.shape[0]), int(w.shape[1])
    left, top, _, _ = _pads(padding)
    if output_size is None:
        output_size = output_shape(tuple(x.shape), int(w.shape[2]), kx, ky, sliding, padding)[1:3]
    h, w_out = output_size
    full = F.conv_transpose2d(
        x.permute(0, 3, 1, 2),  # NCHW view of NHWC memory
        w.permute(3, 2, 0, 1),  # [K, C, ky, kx]: conv2d's OIHW, read as (in, out)
        stride=(sliding[1], sliding[0]),
    )
    fh, fw = full.shape[2], full.shape[3]
    # rows [top, top + h) and columns [left, left + w) of the full output,
    # zero past its edge (negative pads crop)
    y = F.pad(full, (-left, w_out + left - fw, -top, h + top - fh))
    y = y.permute(0, 2, 3, 1)
    return act.get(activation)(y).to(x.dtype)


def depool_with_offset(
    y: torch.Tensor, offset: torch.Tensor, out_shape: Tuple[int, ...]
) -> torch.Tensor:
    """Scatter pooled values back to their argmax positions (znicz
    Depooling): ``offset`` holds the flat ``row * W + col`` input offsets
    of each output element, as ``pooling.max_pool_with_offset`` gives them;
    values landing on one position add."""
    n, h, w, c = out_shape
    flat = torch.zeros((n, h * w, c), dtype=y.dtype, device=y.device)
    flat = flat.scatter_add(1, offset.reshape(n, -1, c).long(), y.reshape(n, -1, c))
    return flat.reshape(n, h, w, c)


def upsample(y: torch.Tensor, kx: int, ky: int) -> torch.Tensor:
    """Nearest-neighbour unpooling (the average pool's adjoint up to scale)."""
    return y.repeat_interleave(ky, dim=1).repeat_interleave(kx, dim=2)
