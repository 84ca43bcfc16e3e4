"""Device selection: the card unless the caller asks for the CPU.

There is no fallback: asking for no device on a machine without CUDA raises,
so a run never quietly trains on the CPU while claiming to measure the card.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve(device: DeviceLike = None) -> torch.device:
    """``None`` -> the CUDA device; ``"cpu"``/``"cuda[:i]"`` as given.

    Raises ``RuntimeError`` when CUDA is wanted (explicitly or by default)
    and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: znicz_tpu_torch runs on the card; pass "
            "device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; want 'cuda' or 'cpu'")
    return dev

