"""Structured weight masking, zero-filling (port of
``znicz_tpu/ops/weights_zerofilling.py``).

A binary mask a weight tensor, re-applied after every update so that the
masked connections stay exactly zero (the reference's grouped and sparse
connectivity experiments).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from znicz_tpu_torch.core import device as device_lib


def make_group_mask(
    n_input: int,
    n_output: int,
    n_groups: int,
    dtype: torch.dtype = torch.float32,
    device: device_lib.DeviceLike = None,
) -> torch.Tensor:
    """Block-diagonal FC mask: group g of the inputs connects only to group
    g of the outputs (AlexNet-style grouped connectivity for an FC layer)."""
    if n_input % n_groups or n_output % n_groups:
        raise ValueError(
            f"groups {n_groups} must divide n_input {n_input} and "
            f"n_output {n_output}"
        )
    dev = device_lib.resolve(device)
    gi, go = n_input // n_groups, n_output // n_groups
    rows = torch.arange(n_input, device=dev)[:, None] // gi
    cols = torch.arange(n_output, device=dev)[None, :] // go
    return (rows == cols).to(dtype)


def apply_masks(
    params: List[Dict[str, torch.Tensor]], masks: Dict[int, Dict[str, torch.Tensor]]
) -> List[Dict[str, torch.Tensor]]:
    """A copy of ``params`` with the masked entries zeroed:
    ``masks[layer_index][param_name]`` -> mask.  The tensors themselves are
    left as they are."""
    if not masks:
        return params
    out = list(params)
    for idx, layer_masks in masks.items():
        layer = dict(out[idx])
        for name, mask in layer_masks.items():
            layer[name] = layer[name] * mask
        out[idx] = layer
    return out


def masked_update(update_fn, masks):
    """Wrap the in-place ``optimizer.update`` so that the masks are applied
    to the updated params afterwards, in place."""

    def wrapped(params, grads, velocity, hyper):
        update_fn(params, grads, velocity, hyper)
        with torch.no_grad():
            for idx, layer_masks in masks.items():
                for name, mask in layer_masks.items():
                    params[idx][name].mul_(mask)

    return wrapped
