"""In-memory full-batch loader (port of ``znicz_tpu/loader/fullbatch.py``).

The whole dataset lives in host arrays; minibatches are gathered by index.
Normalization (``znicz_tpu_torch/loader/normalizers.py``): ``"none"``,
``"linear"``, ``"mean_disp"``, ``"range"`` and ``"external_mean"``; the
fitted kinds are fitted on the ``train`` split, flattened, as in the JAX
package.  uint8 data under ``"range"`` stays uint8 on the host and each
minibatch is gathered and converted by the native
:func:`~znicz_tpu_torch.loader.native.gather_rows_u8`; with
``device_convert`` it crosses to the device as uint8
(:func:`~znicz_tpu_torch.loader.native.gather_rows_u8_raw`), where ``x *
(1/scale) + shift`` runs; other data is normalized once, split by split.

``device_resident=True``: the whole dataset (every split, in
:func:`~znicz_tpu_torch.loader.base.pool_offsets` order, uint8 where it
stays uint8) goes to the device once as the workflow's device context;
each minibatch ships only its int32 pool rows, which
:meth:`FullBatchLoader.device_preproc` gathers (and converts) inside the
step.  Such a loader is ``epoch_scan_friendly``.  ``pool_sharded=True``
(with ``device_resident``) shards the pool over the mesh's data axis:
each rank's device holds its shard's rows and each minibatch ships local
addresses into them (``loader/pool_sharded.py``).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from znicz_tpu_torch.loader import native, normalizers
from znicz_tpu_torch.loader.base import SPLITS, Loader, Minibatch, pool_concat, pool_offsets
from znicz_tpu_torch.loader.pool_sharded import PoolShardedMixin


class FullBatchLoader(PoolShardedMixin, Loader):
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
        # uint8 data under "range" stays uint8: each minibatch is converted
        # by the native gather, or on the device (device_convert)
        self._lazy_u8 = normalization == "range" and all(
            raw.dtype == np.uint8 for raw in self.data.values())
        self._device_convert = device_convert and self._lazy_u8
        self._device_resident = bool(device_resident)
        self.epoch_scan_friendly = self._device_resident
        self._pool_offsets: Dict[str, int] = (
            pool_offsets(self.data) if device_resident else {})
        if pool_sharded and not device_resident:
            raise ValueError("pool_sharded=True requires device_resident")
        self.wants_data_shards = bool(pool_sharded)
        if normalization != "none" and not self._lazy_u8:
            self.data = {
                split: normalizers.apply(
                    self.normalizer, raw.reshape(len(raw), -1).astype(np.float32)
                ).reshape(raw.shape)
                for split, raw in self.data.items()
            }

    def _pool_split_arrays(self):
        return self.data

    def device_context(self):
        """``{"pool": every split in one array}`` when device-resident (this
        process's shard's rows when pool-sharded), built anew at each call
        and not kept (the workflow copies it to the device)."""
        if not self._device_resident:
            return None
        if self.wants_data_shards:
            return {"pool": self._local_pool()}
        return {"pool": pool_concat(self.data)}

    def device_preproc(self):
        if not (self._device_resident or self._device_convert):
            return None
        if self._lazy_u8:
            scale, shift = self.normalizer["scale"], self.normalizer["shift"]

            def convert(x: torch.Tensor) -> torch.Tensor:
                return x.float() * (1.0 / scale) + shift
        else:  # the pool is normalized float32 already: a bare gather

            def convert(x: torch.Tensor) -> torch.Tensor:
                return x

        if not self._device_resident:
            def pre(x: torch.Tensor, ctx=None) -> torch.Tensor:
                return convert(x)

            return pre

        def pre(idx: torch.Tensor, ctx=None) -> torch.Tensor:
            pool = ctx["pool"]
            return convert(pool.index_select(0, idx.reshape(-1)).reshape(
                idx.shape + pool.shape[1:]))

        return pre

    def split_labels(self, split: str):
        return self.labels.get(split)

    @property
    def class_lengths(self) -> Dict[str, int]:
        return {k: len(v) for k, v in self.data.items()}

    @property
    def sample_shape(self) -> tuple:
        return next(iter(self.data.values())).shape[1:]

    def fill(self, indices: np.ndarray, split: str) -> Minibatch:
        raw = self.data[split]
        if self._device_resident:
            # only the pool rows ship (local addresses when pool-sharded);
            # the step gathers them on the device
            if self.data_shards > 1:
                data = self._local_addr(indices, split)
            else:
                data = np.asarray(indices, np.int32) + np.int32(self._pool_offsets[split])
        elif self._device_convert:
            data = native.gather_rows_u8_raw(raw, indices)
        elif self._lazy_u8:
            data = native.gather_rows_u8(raw, indices, scale=self.normalizer["scale"],
                                         shift=self.normalizer["shift"])
        else:
            data = raw[indices]
        labels = self.labels[split][indices] if split in self.labels else None
        targets = self.targets[split][indices] if split in self.targets else None
        return Minibatch(
            data=data, labels=labels, targets=targets, mask=None, indices=indices
        )
