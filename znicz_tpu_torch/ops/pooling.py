"""Max and average pooling (port of ``znicz_tpu/ops/pooling.py``).

NHWC in and out; VALID windows with floor output size; ``sliding=None``
means a window-sized stride.  Computed by ``F.max_pool2d``/``F.avg_pool2d``
on the NCHW view (channels-last memory), as the JAX package left pooling to
XLA's ``reduce_window``.  ``maxabs`` and ``stochastic`` pooling are ported
in a later slice.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def _window(kx: int, ky: int, sliding) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    if sliding is None:
        sliding = (kx, ky)
    return (ky, kx), (sliding[1], sliding[0])


def max_pool(
    x: torch.Tensor, kx: int, ky: int, sliding: Sequence[int] | None = None
) -> torch.Tensor:
    k, s = _window(kx, ky, sliding)
    return F.max_pool2d(x.permute(0, 3, 1, 2), k, s).permute(0, 2, 3, 1)


def avg_pool(
    x: torch.Tensor, kx: int, ky: int, sliding: Sequence[int] | None = None
) -> torch.Tensor:
    k, s = _window(kx, ky, sliding)
    return F.avg_pool2d(x.permute(0, 3, 1, 2), k, s).permute(0, 2, 3, 1)


def output_shape(
    in_shape: Tuple[int, ...], kx: int, ky: int, sliding: Sequence[int] | None = None
) -> Tuple[int, ...]:
    if sliding is None:
        sliding = (kx, ky)
    n, h, w, c = in_shape
    oh = (h - ky) // sliding[1] + 1
    ow = (w - kx) // sliding[0] + 1
    return (n, oh, ow, c)
