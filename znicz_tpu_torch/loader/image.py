"""File-system image loader (port of ``znicz_tpu/loader/image.py``).

Layout (the reference's convention):
    root/train/<class_name>/*.png
    root/valid/<class_name>/*.png   (optional)
    root/test/<class_name>/*.png    (optional)

Images load lazily per minibatch and are resized by nearest neighbour to a
common ``target_shape``.  The JAX package decodes with matplotlib, which
reads through Pillow; the port decodes PNG and uncompressed BMP (1, 4, 8,
24 and 32 bits) itself (numpy and ``zlib``), to the same float32 values
matplotlib gives, so it runs where
neither library is installed.  JPEG goes through Pillow when it can be
imported, as in the JAX package, and raises otherwise.  The format is told
by the file's first bytes.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from znicz_tpu_torch.loader import normalizers
from znicz_tpu_torch.loader.base import SPLITS, Loader, Minibatch

IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp")

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> samples a pixel (grey, RGB, palette, grey+alpha, RGBA)
_PNG_SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}


def _unfilter(raw: bytes, height: int, stride: int, bpp: int, path: str) -> np.ndarray:
    """Undo the PNG row filters (None, Sub, Up, Average, Paeth) of the
    decompressed scanlines; ``bpp`` is the filter's byte distance."""
    if len(raw) < height * (stride + 1):
        raise ValueError(f"{path}: PNG image data is truncated")
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(height):
        pos = r * (stride + 1)
        kind = raw[pos]
        line = np.frombuffer(raw, np.uint8, stride, pos + 1)
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: a running sum over the pixels of each byte lane
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = line + prev
        elif kind in (3, 4):  # Average, Paeth: a recurrence along the row
            lv, up, cv = line.tolist(), prev.tolist(), [0] * stride
            for i in range(stride):
                a = cv[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:
                    cv[i] = (lv[i] + ((a + b) >> 1)) & 0xFF
                    continue
                c = up[i - bpp] if i >= bpp else 0
                pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cv[i] = (lv[i] + pred) & 0xFF
            cur = np.asarray(cv, np.uint8)
        else:
            raise ValueError(f"{path}: PNG row {r} has unknown filter type {kind}")
        out[r] = cur
        prev = out[r]
    return out


def _read_png(path: str, data: bytes) -> np.ndarray:
    """A non-interlaced PNG as matplotlib's ``imread`` returns it: float32
    0..1, grey ``[H, W]``, else ``[H, W, 3]`` or ``[H, W, 4]``; 16-bit grey
    divided by 65535, 16-bit colour cut to its high byte (as Pillow does)."""
    pos, header, palette, idat = 8, None, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{path}: PNG chunk {kind!r} is truncated")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{path}: PNG chunk {kind!r} fails its CRC")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or image data")
    width, height, depth, ctype, _, _, interlace = header
    if interlace:
        raise ValueError(
            f"{path}: interlaced (Adam7) PNG is not supported by the port's "
            "PNG decoder; save the image without interlacing"
        )
    if depth not in _PNG_DEPTHS.get(ctype, ()):
        raise ValueError(f"{path}: PNG colour type {ctype} at bit depth {depth} is invalid")
    samples = _PNG_SAMPLES[ctype]
    bits = samples * depth
    stride = (width * bits + 7) // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), height, stride, max(1, bits // 8), path)
    if depth == 16:
        vals = rows.view(">u2").reshape(height, width, samples)
    elif depth == 8:
        vals = rows.reshape(height, width, samples)
    else:  # 1, 2 or 4 bits a sample (grey or palette), most significant first
        per_byte = 8 // depth
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
        vals = vals.reshape(height, stride * per_byte)[:, :width, None]
    if ctype == 0:  # grey: divided by its depth's full scale
        grey = vals[..., 0]
        if depth in (2, 4):
            # Pillow widens 2- and 4-bit grey to 0..255 before matplotlib
            # divides by 3 or 15, so these run to 85 and 17: JAX's values
            grey = grey * (255 // (2**depth - 1))
        return np.divide(grey, 2**depth - 1, dtype=np.float32)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without a PLTE chunk")
        idx = vals[..., 0].astype(np.intp)
        if idx.size and idx.max() >= len(palette):
            raise ValueError(f"{path}: PNG palette index past the palette")
        return np.divide(palette[idx], 255, dtype=np.float32)  # alpha: dropped later
    u8 = (vals >> 8).astype(np.uint8) if depth == 16 else vals
    if ctype == 4:  # grey + alpha: Pillow's RGBA conversion, grey thrice
        u8 = u8[..., [0, 0, 0, 1]]
    return np.divide(u8, 255, dtype=np.float32)


def _bmp_palette(path: str, data: bytes, dib: int, bits: int) -> Tuple[np.ndarray, str]:
    """A 1-, 4- or 8-bit BMP's colour table as RGB rows, and the mode Pillow
    reads the file in: "L" for the grey ramp ``0..n-1``, "1" for ``0, 255``
    at two colours, else "P"."""
    colors = struct.unpack("<I", data[46:50])[0] or (1 << bits)
    if not 0 < colors <= 65536 or len(data) < 14 + dib + 4 * colors:
        raise ValueError(f"{path}: BMP colour table is truncated or has {colors} colours")
    rgb = np.frombuffer(data, np.uint8, 4 * colors, 14 + dib).reshape(colors, 4)[:, 2::-1]
    ramp = np.array([0, 255]) if colors == 2 else np.arange(colors) & 255
    if np.array_equal(rgb, np.repeat(ramp[:, None], 3, 1)):
        return rgb, "1" if colors == 2 else "L"
    return rgb, "P"


def _read_bmp(path: str, data: bytes) -> np.ndarray:
    """An uncompressed BMP (bottom-up or top-down) as matplotlib gives it
    through Pillow: 24- and 32-bit files as uint8 ``[H, W, 3]`` RGB (a
    32-bit pixel's fourth byte is not read, as Pillow reads such files);
    1-, 4- and 8-bit files through their colour table, in Pillow's mode for
    that table: "L" as the uint8 ``[H, W]`` indices, "1" and "P" as the RGB
    of the RGBA that matplotlib converts them to (its alpha is dropped
    later).  RLE compression raises."""
    if len(data) < 50:
        raise ValueError(f"{path}: BMP header is truncated")
    offset, dib = struct.unpack("<I", data[10:14])[0], struct.unpack("<I", data[14:18])[0]
    if dib < 40:
        raise ValueError(f"{path}: BMP core header ({dib} bytes) is not supported")
    width, height, _, bits, compression = struct.unpack("<iiHHI", data[18:34])
    if bits not in (1, 4, 8, 24, 32) or compression != 0:
        raise ValueError(
            f"{path}: BMP with {bits} bits a pixel and compression {compression} is not "
            "supported by the port's BMP decoder (uncompressed 1, 4, 8, 24 and 32 bits)"
        )
    palette = mode = None
    if bits <= 8:
        palette, mode = _bmp_palette(path, data, dib, bits)
        if offset == 14 + dib:  # Pillow: pixels then start past the table
            offset += 4 * len(palette)
        if (mode == "L" and bits != 8) or (mode == "1" and bits != 1):
            # Pillow then decodes the pixels as 8-bit grey or as bits
            raise ValueError(
                f"{path}: a {bits}-bit BMP with a grey colour table of {len(palette)} "
                "entries is not supported by the port's BMP decoder"
            )
    rows = abs(height)
    stride = (width * bits + 31) // 32 * 4
    if width <= 0 or len(data) < offset + rows * stride:
        raise ValueError(f"{path}: BMP pixel data is truncated")
    px = np.frombuffer(data, np.uint8, rows * stride, offset).reshape(rows, stride)
    if height > 0:
        px = px[::-1]  # bottom-up rows
    if palette is None:
        bpp = bits // 8
        return np.ascontiguousarray(px[:, : width * bpp].reshape(rows, width, bpp)[..., 2::-1])
    if bits == 8:
        idx = px[:, :width]
    elif bits == 4:
        idx = np.stack((px >> 4, px & 15), axis=-1).reshape(rows, -1)[:, :width]
    else:
        idx = np.unpackbits(px, axis=1)[:, :width]
    if mode == "L":
        return np.ascontiguousarray(idx)
    if idx.size and idx.max() >= len(palette):
        raise ValueError(f"{path}: BMP colour index past the colour table")
    return palette[idx]


def _read_jpeg(path: str) -> np.ndarray:
    """A JPEG through Pillow, as matplotlib's ``pil_to_array`` gives it:
    uint8 grey or RGB, other modes (CMYK) converted to RGBA."""
    try:
        from PIL import Image
    except ImportError:
        raise ValueError(
            f"{path}: JPEG needs Pillow to decode, and Pillow is not installed "
            "(the port decodes PNG and BMP itself)"
        ) from None
    with Image.open(path) as im:
        return np.asarray(im if im.mode in ("RGB", "L") else im.convert("RGBA"))


def _read_image(path: str) -> np.ndarray:
    """One image file as float32 in 0..1, ``[H, W, C]``: alpha dropped, a
    grey image ``[H, W, 1]``; equal to the JAX package's ``_read_image``."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(_PNG_SIGNATURE):
        raw = _read_png(path, data)
    elif data.startswith(b"BM"):
        raw = _read_bmp(path, data)
    elif data.startswith(b"\xff\xd8"):
        raw = _read_jpeg(path)
    else:
        raise ValueError(
            f"{path}: not a PNG, BMP or JPEG file (first bytes {data[:8]!r})"
        )
    # integer-decoded formats are 0..255, float (PNG) already 0..1: decided
    # by dtype, never by content
    scale = 255.0 if np.issubdtype(raw.dtype, np.integer) else 1.0
    img = raw.astype(np.float32) / scale
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] == 4:  # drop alpha
        img = img[..., :3]
    return img


def _resize_nearest(img: np.ndarray, h: int, w: int) -> np.ndarray:
    ih, iw = img.shape[:2]
    if (ih, iw) == (h, w):
        return img
    rows = (np.arange(h) * ih / h).astype(np.int64)
    cols = (np.arange(w) * iw / w).astype(np.int64)
    return img[rows][:, cols]


class ImageDirectoryLoader(Loader):
    """Serve labelled images from a directory tree, lazily.

    ``target_shape``: (H, W) or (H, W, C); taken from the first image when
    omitted.  ``grayscale``: average the channels to 1.  ``normalization``:
    "none", "mean_disp", "linear" or "range"; the fitted kinds are fitted
    once, at construction, on up to ``normalization_fit_samples`` training
    images picked at even strides over the (class-major) index, with no
    random draw, and applied per minibatch.
    """

    def __init__(
        self,
        root_dir: str,
        *,
        target_shape: Optional[Tuple[int, ...]] = None,
        grayscale: bool = False,
        normalization: str = "none",
        normalization_kwargs: Optional[dict] = None,
        normalization_fit_samples: int = 512,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.root_dir = root_dir
        self.grayscale = grayscale
        self.index: Dict[str, List[Tuple[str, int]]] = {}
        classes: List[str] = []
        for split in SPLITS:
            split_dir = os.path.join(root_dir, split)
            if not os.path.isdir(split_dir):
                continue
            entries: List[Tuple[str, int]] = []
            for cls in sorted(os.listdir(split_dir)):
                cls_dir = os.path.join(split_dir, cls)
                if not os.path.isdir(cls_dir):
                    continue
                files = [
                    os.path.join(cls_dir, fname)
                    for fname in sorted(os.listdir(cls_dir))
                    if fname.lower().endswith(IMAGE_EXTENSIONS)
                ]
                if not files:
                    continue  # a class exists only if it has samples
                if cls not in classes:
                    classes.append(cls)
                label = classes.index(cls)
                entries.extend((path, label) for path in files)
            if entries:
                self.index[split] = entries
        if not self.index:
            raise FileNotFoundError(
                f"no {'/'.join(SPLITS)}/<class>/*.png images under {root_dir}"
            )
        self.classes = classes
        if target_shape is None:
            first = _read_image(self.index[next(iter(self.index))][0][0])
            target_shape = first.shape[:2]  # channels decided below
        if len(target_shape) == 2:
            target_shape = tuple(target_shape) + (1 if grayscale else 3,)
        if grayscale and target_shape[-1] != 1:
            raise ValueError(f"grayscale=True conflicts with target_shape {target_shape}")
        self.target_shape = tuple(int(s) for s in target_shape)
        if normalization in ("none", "range"):
            self.normalizer = normalizers.fit(
                normalization, np.zeros(0), **(normalization_kwargs or {})
            )
        else:
            split = "train" if "train" in self.index else next(iter(self.index))
            all_entries = self.index[split]
            n_fit = min(normalization_fit_samples, len(all_entries))
            pick = np.linspace(0, len(all_entries) - 1, n_fit).astype(int)
            h, w, c = self.target_shape
            sample = np.stack(
                [self._load_one(all_entries[i][0], h, w, c) for i in pick]
            ).reshape(n_fit, -1)
            self.normalizer = normalizers.fit(
                normalization, sample, **(normalization_kwargs or {})
            )

    @property
    def class_lengths(self) -> Dict[str, int]:
        return {split: len(v) for split, v in self.index.items()}

    @property
    def sample_shape(self) -> tuple:
        return self.target_shape

    def split_labels(self, split: str) -> np.ndarray:
        return np.asarray([label for _, label in self.index[split]], np.int32)

    @staticmethod
    def _load_one(path: str, h: int, w: int, c: int) -> np.ndarray:
        img = _resize_nearest(_read_image(path), h, w)
        if img.shape[-1] != c:
            if c == 1:  # colour source, grey target: the mean (not a slice)
                img = img.mean(axis=-1, keepdims=True)
            elif img.shape[-1] == 1:  # grey source, colour target
                img = np.repeat(img, c, axis=-1)
            else:
                img = img[:, :, :c]
        return img

    def fill(self, indices: np.ndarray, split: str) -> Minibatch:
        h, w, c = self.target_shape
        data = np.zeros((len(indices), h, w, c), np.float32)
        labels = np.zeros(len(indices), np.int32)
        entries = self.index[split]
        for row, idx in enumerate(indices):
            path, label = entries[int(idx)]
            data[row] = self._load_one(path, h, w, c)
            labels[row] = label
        data = normalizers.apply(
            self.normalizer, data.reshape(len(indices), -1)
        ).reshape(data.shape)
        return Minibatch(data=data, labels=labels, targets=None, mask=None, indices=indices)
