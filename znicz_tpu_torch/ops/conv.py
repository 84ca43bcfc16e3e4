"""2-D convolution op (port of ``znicz_tpu/ops/conv.py``).

Public layout as in the JAX package: NHWC activations, HWIO weights
``[ky, kx, C, K]``, ``sliding = (sx, sy)``, ``padding`` the reference's
``(left, top, right, bottom)`` 4-tuple (or ``(px, py)``, or "SAME"/"VALID").
Inside, the NHWC tensor is viewed as NCHW (a permute, so memory stays
channels-last and cuDNN runs its NHWC kernels) and the weights are viewed as
OIHW on the fly.  The conv itself is ``F.conv2d`` (cuDNN on the card), as the
JAX package left it to XLA; backward is autograd.

Not ported: the JAX package's ``space_to_depth`` re-layout, a TPU matrix-unit
trick that is off by default there.  The argument is accepted and every value
computes the same function through the plain conv.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from znicz_tpu_torch.core import device as device_lib, prng
from znicz_tpu_torch.ops import activation as act
from znicz_tpu_torch.ops.filling import fill, to_param

SPACE_TO_DEPTH = ("auto", "always", "never")


def init_params(
    n_channels: int,
    n_kernels: int,
    kx: int,
    ky: int,
    *,
    weights_stddev: Optional[float] = None,
    bias_stddev: Optional[float] = None,
    weights_filling: str = "uniform",
    bias_filling: str = "uniform",
    rand_name: str = "default",
    dtype=torch.float32,
    device: device_lib.DeviceLike = None,
) -> Dict[str, torch.Tensor]:
    dev = device_lib.resolve(device)
    gen = prng.get(rand_name)
    fan_in = kx * ky * n_channels
    if weights_stddev is None:
        weights_stddev = 1.0 / np.sqrt(fan_in)
    if bias_stddev is None:
        bias_stddev = weights_stddev
    w = fill(gen, (ky, kx, n_channels, n_kernels), weights_filling, weights_stddev)
    b = fill(gen, (n_kernels,), bias_filling, bias_stddev)
    return {"weights": to_param(w, dev, dtype), "bias": to_param(b, dev, dtype)}


def _pads(padding, h: int, w: int, kx: int, ky: int, sliding) -> Tuple[int, int, int, int]:
    """Any accepted padding form -> explicit (left, top, right, bottom)."""
    if isinstance(padding, str):
        if padding == "VALID":
            return 0, 0, 0, 0
        if padding != "SAME":
            raise ValueError(f"padding {padding!r}: want 'SAME' or 'VALID'")
        # XLA's SAME: output ceil(in / stride), the extra pad on the high side
        pad_h = max((-(-h // sliding[1]) - 1) * sliding[1] + ky - h, 0)
        pad_w = max((-(-w // sliding[0]) - 1) * sliding[0] + kx - w, 0)
        return pad_w // 2, pad_h // 2, pad_w - pad_w // 2, pad_h - pad_h // 2
    if len(padding) == 2:
        return padding[0], padding[1], padding[0], padding[1]
    left, top, right, bottom = padding
    return left, top, right, bottom


def apply(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,
    *,
    sliding: Sequence[int] = (1, 1),
    padding=(0, 0, 0, 0),
    activation: str = "linear",
    space_to_depth: str = "never",
) -> torch.Tensor:
    """Forward conv, NHWC in and out.  ``sliding`` is (sx, sy)."""
    if space_to_depth not in SPACE_TO_DEPTH:
        raise ValueError(
            f"space_to_depth={space_to_depth!r}: want one of {SPACE_TO_DEPTH}"
        )
    w = params["weights"]
    ky, kx = int(w.shape[0]), int(w.shape[1])
    left, top, right, bottom = _pads(
        padding, x.shape[1], x.shape[2], kx, ky, sliding
    )
    xc = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory
    if left == right and top == bottom:
        pad = (top, left)
    else:  # asymmetric: pad explicitly, then a VALID conv
        xc = F.pad(xc, (left, right, top, bottom))
        pad = (0, 0)
    y = F.conv2d(
        xc,
        w.permute(3, 2, 0, 1),  # HWIO -> OIHW view
        stride=(sliding[1], sliding[0]),  # (sy, sx): spatial order (H, W)
        padding=pad,
    )
    y = y.permute(0, 2, 3, 1) + params["bias"]
    return act.get(activation)(y).to(x.dtype)


def output_shape(
    in_shape: Tuple[int, ...],
    n_kernels: int,
    kx: int,
    ky: int,
    sliding: Sequence[int] = (1, 1),
    padding=(0, 0, 0, 0),
) -> Tuple[int, ...]:
    n, h, w, _ = in_shape
    left, top, right, bottom = _pads(padding, h, w, kx, ky, sliding)
    oh = (h + top + bottom - ky) // sliding[1] + 1
    ow = (w + left + right - kx) // sliding[0] + 1
    return (n, oh, ow, n_kernels)
