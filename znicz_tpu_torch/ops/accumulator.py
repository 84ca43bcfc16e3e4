"""Streaming range/moment accumulator (port of
``znicz_tpu/ops/accumulator.py``).

Accumulates per-feature min, max and sum of a tensor stream (activation
ranges across minibatches, which the reference gathers for fixed-point
deployment analysis): ``init`` -> ``update`` a batch -> read the fields.
The statistics stay on the tensors' device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from znicz_tpu_torch.core import device as device_lib


class RangeStats(NamedTuple):
    lo: torch.Tensor  # per-feature min
    hi: torch.Tensor  # per-feature max
    total: torch.Tensor  # per-feature sum
    count: torch.Tensor  # scalar number of samples

    @property
    def mean(self) -> torch.Tensor:
        return self.total / torch.clamp_min(self.count, 1.0)


def init(
    n_features: int,
    dtype: torch.dtype = torch.float32,
    device: device_lib.DeviceLike = None,
) -> RangeStats:
    """Empty statistics on ``device`` (None: the card, raising without one)."""
    dev = device_lib.resolve(device)
    return RangeStats(
        lo=torch.full((n_features,), torch.inf, dtype=dtype, device=dev),
        hi=torch.full((n_features,), -torch.inf, dtype=dtype, device=dev),
        total=torch.zeros((n_features,), dtype=dtype, device=dev),
        count=torch.zeros((), dtype=dtype, device=dev),
    )


def update(
    stats: RangeStats, x: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> RangeStats:
    """Fold a ``[batch, ...]`` tensor (flattened to ``[batch, features]``)
    into the stats; rows whose ``mask`` is 0 are left out."""
    x = x.reshape(x.shape[0], -1)
    if mask is None:
        valid = torch.ones((x.shape[0],), dtype=x.dtype, device=x.device)
    else:
        valid = mask.to(x.dtype)
    keep = valid[:, None] > 0
    return RangeStats(
        lo=torch.minimum(stats.lo, torch.where(keep, x, torch.inf).amin(dim=0)),
        hi=torch.maximum(stats.hi, torch.where(keep, x, -torch.inf).amax(dim=0)),
        total=stats.total + (x * valid[:, None]).sum(dim=0),
        count=stats.count + valid.sum(),
    )
