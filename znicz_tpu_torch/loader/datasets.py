"""Synthetic dataset constructors (port of the parts of
``znicz_tpu/loader/datasets.py`` the AlexNet slice needs).

Draws from the named "datasets" stream exactly as the JAX package does, so
the same seed gives the same images and labels in both frameworks.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from znicz_tpu_torch.core import prng
from znicz_tpu_torch.loader.fullbatch import FullBatchLoader


def _synthetic_classes(
    n: int,
    shape: Tuple[int, ...],
    n_classes: int,
    *,
    rand_name: str = "datasets",
    sep: float = 2.5,
) -> Tuple[np.ndarray, np.ndarray]:
    """Gaussian blobs around per-class prototype patterns."""
    gen = prng.get(rand_name)
    dim = int(np.prod(shape))
    protos = gen.normal((n_classes, dim), 0.0, 1.0)
    labels = gen.integers(0, n_classes, (n,)).astype(np.int32)
    x = gen.normal((n, dim), 0.0, 1.0) + sep * protos[labels]
    return x.reshape((n,) + shape).astype(np.float32), labels


def _synthetic_split(
    n_train: int,
    n_test: int,
    shape: Tuple[int, ...],
    n_classes: int,
    *,
    test_split: str = "test",
    sep: float = 2.5,
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """One prototype draw shared by both splits, empty splits omitted."""
    x, y = _synthetic_classes(n_train + n_test, shape, n_classes, sep=sep)
    data, labels = {}, {}
    if n_train:
        data["train"], labels["train"] = x[:n_train], y[:n_train]
    if n_test:
        data[test_split], labels[test_split] = x[n_train:], y[n_train:]
    return data, labels


def imagenet_synthetic(
    *,
    image_size: int = 227,
    n_classes: int = 1000,
    n_train: int = 512,
    n_valid: int = 128,
    minibatch_size: int = 128,
    store_u8: bool = True,
    **loader_kwargs,
) -> FullBatchLoader:
    """Synthetic ImageNet-shaped data for the AlexNet workflow.

    ``store_u8`` (default): quantize to uint8 and convert on the device,
    the same u8 -> device -> affine path the real ImageNet loader takes.
    """
    data, labels = _synthetic_split(
        n_train,
        n_valid,
        (image_size, image_size, 3),
        n_classes,
        test_split="valid",
        sep=1.0,
    )
    if store_u8:
        # affine-map the Gaussian blobs into 0..255; "range" 255/-0.5 then
        # lands values in [-.5, .5]
        data = {
            k: np.clip((v + 5.0) * 25.5, 0, 255).astype(np.uint8)
            for k, v in data.items()
        }
        loader_kwargs.setdefault("normalization", "range")
        loader_kwargs.setdefault(
            "normalization_kwargs", {"scale": 255.0, "shift": -0.5}
        )
        loader_kwargs.setdefault("device_convert", True)
    return FullBatchLoader(
        data, labels, minibatch_size=minibatch_size, **loader_kwargs
    )
