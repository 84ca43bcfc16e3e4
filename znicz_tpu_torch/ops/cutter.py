"""Cutter: crop a spatial region out of an NHWC tensor (port of
``znicz_tpu/ops/cutter.py``).  The forward is a slice; its backward
(zero-padding the gradient back to the input's shape) is autograd.
"""

from __future__ import annotations

import torch


def cut(x: torch.Tensor, padding) -> torch.Tensor:
    """Crop by the reference's 4-tuple (left, top, right, bottom)."""
    left, top, right, bottom = padding
    h, w = x.shape[1], x.shape[2]
    return x[:, top : h - bottom, left : w - right, :]


def output_shape(in_shape, padding):
    left, top, right, bottom = padding
    n, h, w, c = in_shape
    return (n, h - top - bottom, w - left - right, c)
