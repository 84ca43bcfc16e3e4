"""In-memory full-batch loader (port of ``znicz_tpu/loader/fullbatch.py``).

The whole dataset lives in host arrays; minibatches are gathered by index.
Normalization (``znicz_tpu_torch/loader/normalizers.py``): ``"none"``,
``"linear"``, ``"mean_disp"``, ``"range"`` and ``"external_mean"``; the
fitted kinds are fitted on the ``train`` split, flattened, as in the JAX
package, and each split is normalized once on the host.  With
``device_convert``, uint8 data under "range" stays uint8 and crosses to the
device as uint8 (a quarter of the bytes), where ``x * (1/scale) + shift``
runs, as in the JAX package.  The device-resident pool
(``device_resident=True``) and pool sharding are refused by name.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from znicz_tpu_torch.loader import normalizers
from znicz_tpu_torch.loader.base import SPLITS, Loader, Minibatch


class FullBatchLoader(Loader):
    """Serve minibatches from per-split in-memory arrays.

    ``data[split]``: [n, ...] array; ``labels[split]``: [n] ints or None;
    ``targets[split]``: regression/AE targets or None.
    """

    def __init__(
        self,
        data: Dict[str, np.ndarray],
        labels: Optional[Dict[str, np.ndarray]] = None,
        targets: Optional[Dict[str, np.ndarray]] = None,
        *,
        normalization: str = "none",
        normalization_kwargs: Optional[dict] = None,
        device_convert: bool = False,
        device_resident: bool = False,
        pool_sharded: bool = False,
        **kwargs,
    ):
        if pool_sharded:
            raise NotImplementedError(
                "pool sharding (pool_sharded=True) is not ported to znicz_tpu_torch "
                "yet (ROADMAP.md A6, loader/pool_sharded.py)"
            )
        if device_resident:
            raise NotImplementedError(
                "the device-resident pool (device_resident=True) is not ported to "
                "znicz_tpu_torch yet (ROADMAP.md A3, loader/fullbatch.py)"
            )
        super().__init__(**kwargs)
        # zero-length splits are simply absent
        self.data = {
            k: np.asarray(v) for k, v in data.items() if v is not None and len(v)
        }
        if not self.data:
            raise ValueError("FullBatchLoader needs at least one non-empty split")
        self.labels = {
            k: np.asarray(v, np.int32) for k, v in (labels or {}).items() if v is not None
        }
        self.targets = {
            k: np.asarray(v) for k, v in (targets or {}).items() if v is not None
        }
        for split in self.data:
            if split not in SPLITS:
                raise ValueError(f"unknown split {split!r}")
        train = self.data.get("train")
        if train is None and normalization in ("linear", "mean_disp"):
            raise ValueError(
                f"normalization={normalization!r} must be fitted on a "
                "'train' split, but this loader has none"
            )
        fit_src = train if train is not None else np.zeros((1, 1))
        self.normalizer = normalizers.fit(
            normalization,
            fit_src.reshape(len(fit_src), -1),
            **(normalization_kwargs or {}),
        )
        self.normalization = normalization
        # uint8 data under "range" may stay uint8 up to the device
        self._device_convert = (
            device_convert
            and normalization == "range"
            and all(raw.dtype == np.uint8 for raw in self.data.values())
        )
        if normalization != "none" and not self._device_convert:
            self.data = {
                split: normalizers.apply(
                    self.normalizer, raw.reshape(len(raw), -1).astype(np.float32)
                ).reshape(raw.shape)
                for split, raw in self.data.items()
            }

    def device_preproc(self):
        if not self._device_convert:
            return None
        scale, shift = self.normalizer["scale"], self.normalizer["shift"]

        def pre(x: torch.Tensor) -> torch.Tensor:
            return x.float() * (1.0 / scale) + shift

        return pre

    @property
    def class_lengths(self) -> Dict[str, int]:
        return {k: len(v) for k, v in self.data.items()}

    @property
    def sample_shape(self) -> tuple:
        return next(iter(self.data.values())).shape[1:]

    def fill(self, indices: np.ndarray, split: str) -> Minibatch:
        data = self.data[split][indices]
        labels = self.labels[split][indices] if split in self.labels else None
        targets = self.targets[split][indices] if split in self.targets else None
        return Minibatch(
            data=data, labels=labels, targets=targets, mask=None, indices=indices
        )
