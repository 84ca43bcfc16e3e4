"""ImageNet-style pipeline: pack, crop, flip, normalize on the device
(port of ``znicz_tpu/loader/imagenet.py``, its host-crop path).

- **Pack once.**  ``pack_image_dir`` turns a ``<split>/<class>/<image>``
  tree into per-split u8 ``.npy`` arrays (short side resized to ``size``,
  centre-cropped to ``size`` x ``size``), written incrementally; the same
  bytes, ``classes.json`` and ``mean_rgb.json`` as the JAX package's.
- **Crop natively.**  The loader memory-maps the packed arrays; each
  minibatch's random crops and flips (train) or centre crops (valid, test)
  are cut by ``loader/native.py::crop_gather_u8``, the C++ of
  ``native/batch_assembler.cc``.
- **Normalize on the device.**  Batches stay uint8 up to the device, where
  :meth:`ImageNetLoader.device_preproc` gives ``x * (1/255) - mean``.
- **Or keep the pool on the device** (``device_resident=True``).  The
  packed u8 splits go to the device once, in
  :func:`~znicz_tpu_torch.loader.base.pool_offsets` order, as the
  workflow's device context; each minibatch ships an int32 ``[B, 4]``
  payload (pool row, ``oy``, ``ox``, flip), the same draws as the host
  path, and :meth:`~ImageNetLoader.device_preproc` cuts each crop straight
  out of the pool by indexing over an index grid, reversed along W where
  the flip bit is set, then normalizes.  The crops are the host native
  crops' bytes.  Such a loader is ``epoch_scan_friendly``.

Pool sharding (``pool_sharded=True``, ROADMAP.md A6) is refused by name.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from znicz_tpu_torch.core import prng
from znicz_tpu_torch.loader import native
from znicz_tpu_torch.loader.base import (
    SPLITS,
    TRAIN,
    Loader,
    Minibatch,
    pool_concat,
    pool_offsets,
)
from znicz_tpu_torch.loader.image import IMAGE_EXTENSIONS, _read_image

MEAN_FILE = "mean_rgb.json"
CLASSES_FILE = "classes.json"


def _resize_short_side(img: np.ndarray, size: int) -> np.ndarray:
    """Nearest-neighbour resize so the short side equals ``size`` (aspect
    kept)."""
    h, w = img.shape[:2]
    if h <= w:
        nh, nw = size, max(size, int(round(w * size / h)))
    else:
        nh, nw = max(size, int(round(h * size / w))), size
    rows = np.minimum((np.arange(nh) * h / nh).astype(np.int64), h - 1)
    cols = np.minimum((np.arange(nw) * w / nw).astype(np.int64), w - 1)
    return img[rows][:, cols]


def _center_crop(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    oy, ox = (h - size) // 2, (w - size) // 2
    return img[oy:oy + size, ox:ox + size]


def _to_u8_rgb(img: np.ndarray, size: int) -> np.ndarray:
    """A decoded float image (0..1) -> the canonical ``[size, size, 3]`` u8."""
    img = _center_crop(_resize_short_side(img, size), size)
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    return np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)


def pack_image_dir(
    src_dir: str, out_dir: str, *, size: int = 256, verbose: bool = False
) -> Dict[str, int]:
    """One-time preparation: ``src_dir/<split>/<class>/<image>`` ->
    ``<split>_images.npy`` ([n, size, size, 3] u8), ``<split>_labels.npy``
    ([n] int32), ``classes.json`` and ``mean_rgb.json`` (the train split's
    channel means, 0..1) in ``out_dir``.  Returns the samples a split."""
    from numpy.lib.format import open_memmap

    os.makedirs(out_dir, exist_ok=True)
    classes: list = []
    counts: Dict[str, int] = {}
    mean_acc, mean_n = np.zeros(3, np.float64), 0
    for split in SPLITS:
        split_dir = os.path.join(src_dir, split)
        if not os.path.isdir(split_dir):
            continue
        entries = []
        for cls in sorted(os.listdir(split_dir)):
            cls_dir = os.path.join(split_dir, cls)
            if not os.path.isdir(cls_dir):
                continue
            files = [
                os.path.join(cls_dir, f)
                for f in sorted(os.listdir(cls_dir))
                if f.lower().endswith(IMAGE_EXTENSIONS)
            ]
            if not files:
                continue
            if cls not in classes:
                classes.append(cls)
            entries.extend((p, classes.index(cls)) for p in files)
        if not entries:
            continue
        # written image by image: the split is never held in memory whole
        images = open_memmap(
            os.path.join(out_dir, f"{split}_images.npy"),
            mode="w+", dtype=np.uint8, shape=(len(entries), size, size, 3),
        )
        labels = np.empty(len(entries), np.int32)
        for i, (path, label) in enumerate(entries):
            images[i] = _to_u8_rgb(_read_image(path), size)
            labels[i] = label
            if split == TRAIN:
                mean_acc += images[i].reshape(-1, 3).mean(axis=0) / 255.0
                mean_n += 1
            if verbose and (i + 1) % 1000 == 0:
                print(f"{split}: {i + 1}/{len(entries)}")
        images.flush()
        del images
        np.save(os.path.join(out_dir, f"{split}_labels.npy"), labels)
        counts[split] = len(entries)
    if not counts:
        raise FileNotFoundError(f"no {'/'.join(SPLITS)}/<class>/<image> files under {src_dir}")
    with open(os.path.join(out_dir, CLASSES_FILE), "w") as f:
        json.dump(classes, f)
    mean_rgb = (mean_acc / max(mean_n, 1)).tolist() if mean_n else [0.5] * 3
    with open(os.path.join(out_dir, MEAN_FILE), "w") as f:
        json.dump(mean_rgb, f)
    return counts


def _read_json(path: str):
    with open(path) as f:
        return json.load(f)


class ImageNetLoader(Loader):
    """Packed-u8 image loader with the reference's augmentation.

    ``data_dir`` holds ``pack_image_dir``'s output, or a raw image tree,
    which is packed into ``data_dir/.packed<pack_size>`` on first use.  Train
    minibatches are random ``crop_size`` crops with random horizontal flips
    (``oy``, ``ox``, then ``flip`` drawn from the loader's stream, as in the
    JAX package); valid and test take the centre crop.  Minibatches stay
    uint8; :meth:`device_preproc` converts them on the device.
    """

    def __init__(
        self,
        data_dir: str,
        *,
        crop_size: int = 227,
        pack_size: int = 256,
        random_flip: bool = True,
        mean_rgb: Optional[Tuple[float, float, float]] = None,
        mmap: bool = True,
        device_resident: bool = False,
        pool_sharded: bool = False,
        **kwargs,
    ):
        if pool_sharded:
            raise NotImplementedError(
                "pool sharding (pool_sharded=True) is not ported to znicz_tpu_torch "
                "yet (ROADMAP.md A6, loader/pool_sharded.py)"
            )
        super().__init__(**kwargs)
        self._device_resident = bool(device_resident)
        self.epoch_scan_friendly = self._device_resident
        if not os.path.isdir(data_dir):
            raise FileNotFoundError(f"no such data_dir: {data_dir}")
        if not os.path.exists(os.path.join(data_dir, f"{TRAIN}_images.npy")):
            packed = os.path.join(data_dir, f".packed{pack_size}")
            if not os.path.exists(os.path.join(packed, f"{TRAIN}_images.npy")):
                pack_image_dir(data_dir, packed, size=pack_size)
            data_dir = packed
        self.data_dir = data_dir
        self.crop_size = int(crop_size)
        self.random_flip = random_flip
        self.images: Dict[str, np.ndarray] = {}
        self.labels: Dict[str, np.ndarray] = {}
        for split in SPLITS:
            ipath = os.path.join(data_dir, f"{split}_images.npy")
            if not os.path.exists(ipath):
                continue
            self.images[split] = np.load(ipath, mmap_mode="r" if mmap else None)
            self.labels[split] = np.load(os.path.join(data_dir, f"{split}_labels.npy"))
        if TRAIN not in self.images:
            raise FileNotFoundError(f"no train_images.npy under {data_dir}")
        h = self.images[TRAIN].shape[1]
        if self.crop_size > h:
            raise ValueError(f"crop_size {crop_size} exceeds packed image size {h}")
        cpath = os.path.join(data_dir, CLASSES_FILE)
        self.classes = _read_json(cpath) if os.path.exists(cpath) else None
        if mean_rgb is None:
            mpath = os.path.join(data_dir, MEAN_FILE)
            mean_rgb = tuple(_read_json(mpath)) if os.path.exists(mpath) else (0.5, 0.5, 0.5)
        self.mean_rgb = np.asarray(mean_rgb, np.float32)
        self._pool_offsets = pool_offsets(self.images)

    @property
    def class_lengths(self) -> Dict[str, int]:
        return {k: len(v) for k, v in self.images.items()}

    @property
    def sample_shape(self) -> tuple:
        return (self.crop_size, self.crop_size, 3)

    def split_labels(self, split: str):
        return self.labels.get(split)

    def n_classes(self) -> int:
        if self.classes is not None:
            return len(self.classes)
        return int(self.labels[TRAIN].max()) + 1

    def _crop_params(self, indices: np.ndarray, split: str):
        _, h, w, _ = self.images[split].shape
        cs = self.crop_size
        b = len(indices)
        if split == TRAIN:
            gen = prng.get(self.rand_name)
            oy = gen.integers(0, h - cs + 1, (b,)).astype(np.int64)
            ox = gen.integers(0, w - cs + 1, (b,)).astype(np.int64)
            flip = (
                gen.integers(0, 2, (b,)).astype(np.uint8)
                if self.random_flip
                else np.zeros(b, np.uint8)
            )
        else:
            oy = np.full(b, (h - cs) // 2, np.int64)
            ox = np.full(b, (w - cs) // 2, np.int64)
            flip = np.zeros(b, np.uint8)
        return oy, ox, flip

    def fill(self, indices: np.ndarray, split: str) -> Minibatch:
        oy, ox, flip = self._crop_params(indices, split)
        cs = self.crop_size
        if self._device_resident:
            # the whole transfer of the minibatch: pool row, crop, flip bit
            row = np.asarray(indices, np.int64) + self._pool_offsets[split]
            data = np.stack([row, oy, ox, flip.astype(np.int64)], axis=1).astype(np.int32)
        else:
            data = native.crop_gather_u8(self.images[split], indices, oy, ox, flip, cs, cs)
        return Minibatch(
            data=data,
            labels=self.labels[split][indices],
            targets=None,
            mask=None,
            indices=indices,
        )

    def device_context(self):
        """``{"pool": every packed split in one u8 array}`` when
        device-resident (read from the memory maps at each call and not
        kept: the workflow copies it to the device)."""
        if not self._device_resident:
            return None
        return {"pool": pool_concat(self.images)}

    def device_preproc(self):
        """u8 -> float32 in [-mean, 1 - mean], on the batch's device; when
        device-resident, the crops are cut out of ``ctx["pool"]`` first
        (:func:`crop_from_pool`)."""
        mean = torch.from_numpy(self.mean_rgb)
        on_device = {}
        cs = self.crop_size
        resident = self._device_resident

        def pre(x: torch.Tensor, ctx=None) -> torch.Tensor:
            if resident:
                x = crop_from_pool(ctx["pool"], x, cs)
            m = on_device.get(x.device)
            if m is None:
                m = on_device[x.device] = mean.to(x.device)
            return x.float() * (1.0 / 255.0) - m

        return pre


def crop_from_pool(pool: torch.Tensor, payload: torch.Tensor, size: int) -> torch.Tensor:
    """The ``[B, size, size, C]`` crops of the ``[B, 4]`` payload (pool row,
    ``oy``, ``ox``, flip) out of ``pool [N, H, W, C]``, on the pool's
    device: one gather over an index grid, W reversed where the flip bit
    is set (the bytes :func:`native.crop_gather_u8` cuts on the host)."""
    p = payload.long()
    ar = torch.arange(size, device=pool.device)
    rows = p[:, 0, None, None]
    ys = (p[:, 1, None] + ar)[:, :, None]
    cols = torch.where(p[:, 3, None] > 0, size - 1 - ar, ar)
    xs = (p[:, 2, None] + cols)[:, None, :]
    return pool[rows, ys, xs]
