"""Max, average, max-abs and stochastic pooling (port of
``znicz_tpu/ops/pooling.py``).

NHWC in and out; VALID windows with floor output size; ``sliding=None``
means a window-sized stride.  Max and average pooling are
``F.max_pool2d``/``F.avg_pool2d`` on the NCHW view (channels-last memory),
as the JAX package left them to XLA's ``reduce_window``.  Max-abs,
max-with-offset and stochastic pooling pick one element a window from the
JAX package's patch view (:func:`_patches`: ``[N, OH, OW, ky*kx, C]``, the
window read row by row), with ``torch.argmax``'s first-index tie breaking,
as ``jnp.argmax`` breaks ties.  Backward passes are autograd.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from znicz_tpu_torch.parallel.data_parallel import batch_rand


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


def _patches(x: torch.Tensor, kx: int, ky: int, sliding) -> torch.Tensor:
    """``[N, OH, OW, ky*kx, C]`` view of the pooling windows, each read row
    by row (the JAX package's im2col order)."""
    if sliding is None:
        sliding = (kx, ky)
    p = x.unfold(1, ky, sliding[1]).unfold(2, kx, sliding[0])  # [N, OH, OW, C, ky, kx]
    n, oh, ow, c = p.shape[:4]
    return p.reshape(n, oh, ow, c, ky * kx).movedim(-1, 3)


def _pick(p: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The element at window index ``idx`` ``[N, OH, OW, C]`` of patches ``p``."""
    return torch.gather(p, 3, idx.unsqueeze(3)).squeeze(3)


def max_abs_pool(
    x: torch.Tensor, kx: int, ky: int, sliding: Sequence[int] | None = None
) -> torch.Tensor:
    """Select the element with the largest magnitude, keeping its sign."""
    p = _patches(x, kx, ky, sliding)
    return _pick(p, torch.argmax(p.abs(), dim=3))


def max_pool_with_offset(
    x: torch.Tensor, kx: int, ky: int, sliding: Sequence[int] | None = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Max pooling returning (values, flat input offsets ``row * W + col``
    in ``[0, H*W)``, int64) for depooling."""
    if sliding is None:
        sliding = (kx, ky)
    w = x.shape[2]
    p = _patches(x, kx, ky, sliding)
    idx = torch.argmax(p, dim=3)  # [N, OH, OW, C] in-window index
    oh, ow = idx.shape[1], idx.shape[2]
    base_row = torch.arange(oh, device=x.device)[None, :, None, None] * sliding[1]
    base_col = torch.arange(ow, device=x.device)[None, None, :, None] * sliding[0]
    offset = (base_row + idx // kx) * w + (base_col + idx % kx)
    return _pick(p, idx), offset


def stochastic_pool(
    x: torch.Tensor,
    kx: int,
    ky: int,
    sliding: Sequence[int] | None = None,
    *,
    generator: Optional[torch.Generator] = None,
    train: bool = True,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Stochastic pooling (Zeiler & Fergus, znicz StochasticPooling).

    Train: one element a window, drawn with probability proportional to its
    positive part, by Gumbel-max over ``log p``; a window with no positive
    value takes its max-abs element.  Eval: the expectation under ``p``.
    The Gumbel noise (the window shape ``[N, OH, OW, ky*kx, C]``) is
    ``noise`` when given, else drawn from ``generator``; the draws cannot
    follow the JAX package's threefry keys.
    """
    p = _patches(x, kx, ky, sliding)  # [N, OH, OW, K, C]
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    pos = torch.maximum(p, zero)
    total = pos.sum(dim=3, keepdim=True)
    probs = torch.where(total > 0, pos / torch.clamp_min(total, 1e-30), zero)
    if not train:
        return (probs * p).sum(dim=3)
    if noise is None:
        if generator is None:
            raise ValueError("stochastic_pool(train=True) needs a torch.Generator")
        # drawn for the global batch under data parallelism (batch_rand)
        u = batch_rand(probs.shape, generator=generator, device=p.device, dtype=p.dtype)
        noise = -torch.log(-torch.log(u.clamp_min(torch.finfo(p.dtype).tiny)))
    logp = torch.where(probs > 0, torch.log(torch.clamp_min(probs, 1e-30)), -math.inf)
    scores = torch.where(total > 0, logp + noise.to(p.dtype), p.abs())
    return _pick(p, torch.argmax(scores, dim=3))


def output_shape(
    in_shape: Tuple[int, ...], kx: int, ky: int, sliding: Sequence[int] | None = None
) -> Tuple[int, ...]:
    if sliding is None:
        sliding = (kx, ky)
    n, h, w, c = in_shape
    oh = (h - ky) // sliding[1] + 1
    ow = (w - kx) // sliding[0] + 1
    return (n, oh, ow, c)
