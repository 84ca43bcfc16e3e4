"""Dataset constructors (port of ``znicz_tpu/loader/datasets.py``: MNIST,
CIFAR-10, UCI Wine and the synthetic ImageNet stand-in).

Each reads its standard on-disk format when given a path that holds it
(MNIST's IDX files, CIFAR-10's python-pickle batches, Wine's CSV), and
otherwise makes the JAX package's synthetic stand-in of the same shapes.
The synthetic data draws from the named "datasets" stream exactly as the
JAX package does, so the same seed gives the same samples and labels in
both frameworks.
"""

from __future__ import annotations

import gzip
import os
import pickle
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


def cifar10(
    data_dir: Optional[str] = None,
    *,
    minibatch_size: int = 100,
    n_train: int = 2000,
    n_test: int = 500,
    **loader_kwargs,
) -> FullBatchLoader:
    """CIFAR-10 in NHWC: the python-pickle batches of ``data_dir`` when it
    holds all of them (``data_batch_1`` to ``_5`` and ``test_batch``), else
    the synthetic 32x32x3, 10-class stand-in sized (``n_train``,
    ``n_test``).  Real images stay uint8 under "range" 255/-0.5 unless the
    caller names a normalization, which then gets them as ``x / 255 - 0.5``
    in float32, as in the JAX package."""
    data: Dict[str, np.ndarray] = {}
    labels: Dict[str, np.ndarray] = {}
    if data_dir:
        batch_paths = [os.path.join(data_dir, f"data_batch_{i}") for i in range(1, 6)]
        test_path = os.path.join(data_dir, "test_batch")
        if all(os.path.exists(p) for p in batch_paths + [test_path]):
            data["train"], labels["train"] = _read_cifar_batches(batch_paths)
            data["test"], labels["test"] = _read_cifar_batches([test_path])
            if "normalization" in loader_kwargs:
                data = {k: v.astype(np.float32) / 255.0 - 0.5 for k, v in data.items()}
            else:
                loader_kwargs["normalization"] = "range"
                loader_kwargs["normalization_kwargs"] = {"scale": 255.0, "shift": -0.5}
    if not data:
        data, labels = _synthetic_split(n_train, n_test, (32, 32, 3), 10)
    return FullBatchLoader(data, labels, minibatch_size=minibatch_size, **loader_kwargs)


def _read_cifar_batches(paths) -> Tuple[np.ndarray, np.ndarray]:
    """CIFAR-10's python-pickle batch files -> uint8 NHWC images and int32
    labels.  Unpickling runs code, so ``data_dir`` must be trusted."""
    xs, ys = [], []
    for p in paths:
        with open(p, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        xs.append(np.asarray(d[b"data"], np.uint8))
        ys.append(np.asarray(d[b"labels"], np.int32))
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return np.ascontiguousarray(x), np.concatenate(ys)


def wine(
    data_path: Optional[str] = None,
    *,
    minibatch_size: int = 10,
    **loader_kwargs,
) -> FullBatchLoader:
    """UCI Wine (one ``train`` split): the ``wine.data`` CSV at
    ``data_path`` when it exists (the class, 1-3, then 13 features a row),
    else the synthetic 178 x 13, 3-class stand-in; "mean_disp"
    normalization unless the caller names another."""
    if data_path and os.path.exists(data_path):
        raw = np.loadtxt(data_path, delimiter=",")
        labels_all = raw[:, 0].astype(np.int32) - 1
        x_all = raw[:, 1:].astype(np.float32)
    else:
        x_all, labels_all = _synthetic_classes(178, (13,), 3, sep=3.0)
    return FullBatchLoader(
        {"train": x_all},
        {"train": labels_all},
        minibatch_size=minibatch_size,
        normalization=loader_kwargs.pop("normalization", "mean_disp"),
        **loader_kwargs,
    )


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
