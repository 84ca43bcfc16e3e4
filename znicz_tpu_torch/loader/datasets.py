"""Dataset constructors (port of the parts of ``znicz_tpu/loader/datasets.py``
the ported slices need: MNIST and the synthetic ImageNet stand-in).

MNIST reads the standard IDX files when a data directory holds them, and
otherwise makes the JAX package's synthetic 28x28, 10-class stand-in.  The
synthetic data draws from the named "datasets" stream exactly as the JAX
package does, so the same seed gives the same images and labels in both
frameworks.
"""

from __future__ import annotations

import gzip
import os
from typing import Dict, Optional, Tuple

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


def _read_idx(path: str) -> np.ndarray:
    """One IDX file (``.gz`` or plain) as a uint8 array of its dimensions."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = int.from_bytes(f.read(4), "big")
        ndim = magic & 0xFF
        dims = [int.from_bytes(f.read(4), "big") for _ in range(ndim)]
        return np.frombuffer(f.read(), np.uint8).reshape(dims)


def mnist(
    data_dir: Optional[str] = None,
    *,
    minibatch_size: int = 100,
    validation_ratio: float = 0.0,
    flat: bool = True,
    n_train: int = 2000,
    n_test: int = 500,
    **loader_kwargs,
) -> FullBatchLoader:
    """MNIST: the IDX files of ``data_dir`` when it holds them (train and
    t10k, plain or ``.gz``), else the synthetic 28x28, 10-class stand-in
    sized (``n_train``, ``n_test``).  ``validation_ratio`` moves the first
    part of train to "valid"; ``flat`` gives ``[n, 784]`` samples, else
    ``[n, 28, 28, 1]``.  Real images stay uint8 under "range" 255/-0.5
    unless the caller names a normalization, which then gets them as
    ``x / 255 - 0.5`` in float32, as in the JAX package."""
    data: Dict[str, np.ndarray] = {}
    labels: Dict[str, np.ndarray] = {}
    if data_dir:
        names = {
            "train": ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
            "test": ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
        }
        for split, (ims, labs) in names.items():
            for suffix in ("", ".gz"):
                ip = os.path.join(data_dir, ims + suffix)
                lp = os.path.join(data_dir, labs + suffix)
                if os.path.exists(ip) and os.path.exists(lp):
                    data[split] = _read_idx(ip)
                    labels[split] = _read_idx(lp).astype(np.int32)
                    break
        if set(data) not in (set(), {"train", "test"}):
            raise FileNotFoundError(
                f"{data_dir} holds only the {sorted(data)} MNIST split(s); "
                "need both train-* and t10k-* IDX files (or none, for the "
                "synthetic stand-in)"
            )
        if data:
            if "normalization" in loader_kwargs:
                data = {k: v.astype(np.float32) / 255.0 - 0.5 for k, v in data.items()}
            else:
                loader_kwargs["normalization"] = "range"
                loader_kwargs["normalization_kwargs"] = {"scale": 255.0, "shift": -0.5}
    if not data:
        data, labels = _synthetic_split(n_train, n_test, (28, 28), 10)
    if validation_ratio > 0:
        n = len(data["train"])
        nv = int(n * validation_ratio)
        data["valid"], labels["valid"] = data["train"][:nv], labels["train"][:nv]
        data["train"], labels["train"] = data["train"][nv:], labels["train"][nv:]
    if flat:
        data = {k: v.reshape(len(v), -1) for k, v in data.items()}
    else:
        data = {k: v.reshape(len(v), 28, 28, 1) for k, v in data.items()}
    return FullBatchLoader(data, labels, minibatch_size=minibatch_size, **loader_kwargs)


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
