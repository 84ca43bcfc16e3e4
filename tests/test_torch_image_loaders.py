"""The port's image-file loaders against the JAX package's, on the CPU.

Image trees are written to a temp dir from numpy seeds: with Pillow, with
matplotlib, and with a test-local PNG and BMP writer that forces each PNG
row filter, colour type and bit depth.  The port's own PNG and BMP decoder
gives JAX's ``_read_image`` (matplotlib over Pillow) bitwise; JPEG goes
through Pillow in both.  ``ImageDirectoryLoader``'s classes, index,
normalizer and batches, ``pack_image_dir``'s files, ``crop_gather_u8`` and
``ImageNetLoader``'s batches are equal to JAX's exactly under one seed;
``device_preproc`` within rtol 1e-6 / atol 1e-7.  Kanji and Yale Faces
(synthetic, and Kanji from a PNG tree) and AlexNet through ``data_dir``
(a raw tree packed at 32, crop 27, a small AlexNet-shaped layer list in
f32) train 2 epochs in both frameworks: loss and n_err within rtol 1e-4,
final weights within rtol 1e-4 / atol 1e-5, initial weights exactly.
"""

import json
import os
import shutil
import struct
import sys
import zlib

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_slice import _names_its_item
from znicz_tpu.core import prng as jprng
from znicz_tpu.core.config import root as jroot
from znicz_tpu.loader import image as jimage, imagenet as jimagenet, native as jnative
from znicz_tpu.loader import FullBatchLoader as JaxFullBatch
from znicz_tpu.models import alexnet as jax_alexnet, kanji as jax_kanji, yale_faces as jax_yale
from znicz_tpu_torch.core import prng as tprng
from znicz_tpu_torch.core.config import root as troot
from znicz_tpu_torch.loader import ImageDirectoryLoader, ImageNetLoader, image, native
from znicz_tpu_torch.loader import imagenet as timagenet, pack_image_dir
from znicz_tpu_torch.loader.fullbatch import FullBatchLoader
from znicz_tpu_torch.models import alexnet, kanji, yale_faces
from znicz_tpu_torch.workflow import model as model_lib

torch.set_float32_matmul_precision("highest")
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

SEED = 2468
RTOL_EPOCH = 1e-4
RTOL_W, ATOL_W = 1e-4, 1e-5


def _seed_both():
    for reg in (jprng, tprng):
        reg.reset()
        reg.seed_all(SEED)


# -- a test-local PNG and BMP writer ------------------------------------------

def _paeth(a, b, c):
    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter_row(kind, cur, prev, bpp):
    out = [kind]
    for i, x in enumerate(cur):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[kind]
        out.append((x - pred) & 0xFF)
    return bytes(out)


def _pack_rows(samples, depth):
    """``[H, W, S]`` sample values -> ``[H, stride]`` bytes, MSB first."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1).astype(np.int64)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return flat.astype(np.uint8)
    per_byte = 8 // depth
    pad = -flat.shape[1] % per_byte
    flat = np.concatenate([flat, np.zeros((h, pad), np.int64)], axis=1)
    flat = flat.reshape(h, -1, per_byte)
    shifts = 8 - depth * (np.arange(per_byte) + 1)
    return (flat << shifts).sum(axis=2).astype(np.uint8)


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def write_png(path, samples, ctype, depth, filters, palette=None, interlace=0):
    """A PNG of ``samples`` ``[H, W, S]`` with row ``r`` filtered by
    ``filters[r % len(filters)]`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    h, w, s = samples.shape
    rows = _pack_rows(samples, depth)
    bpp = max(1, s * depth // 8)
    raw, prev = b"", [0] * rows.shape[1]
    for r in range(h):
        cur = rows[r].tolist()
        raw += _filter_row(filters[r % len(filters)], cur, prev, bpp)
        prev = cur
    data = b"\x89PNG\r\n\x1a\n" + _chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        data += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    data += _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(data)


def write_bmp(path, rgb, bits, top_down, fourth=None):
    """An uncompressed 24- or 32-bit BMP of ``rgb`` ``[H, W, 3]`` u8."""
    h, w, _ = rgb.shape
    px = rgb[..., ::-1]
    if bits == 32:
        px = np.concatenate([px, fourth if fourth is not None else np.full((h, w, 1), 255,
                                                                            np.uint8)], axis=2)
    stride = (w * bits + 31) // 32 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, : w * bits // 8] = px.reshape(h, -1)
    if not top_down:
        rows = rows[::-1]
    body = rows.tobytes()
    header = b"BM" + struct.pack("<IHHI", 54 + len(body), 0, 0, 54) + struct.pack(
        "<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bits, 0, len(body), 2835, 2835, 0, 0)
    with open(path, "wb") as f:
        f.write(header + body)


# (colour type, bit depth): every one PNG allows
PNG_MODES = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2),
             (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]
PNG_SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
FILTERS = {"none": [0], "sub": [1], "up": [2], "average": [3], "paeth": [4],
           "mixed": [0, 1, 2, 3, 4]}


def _png_samples(rng, ctype, depth, h=7, w=13):
    hi = 2**depth
    samples = rng.integers(0, hi, (h, w, PNG_SAMPLES[ctype]))
    palette = rng.integers(0, 256, (hi, 3)) if ctype == 3 else None
    return samples, palette


def _same(port, want):
    want = np.asarray(want)
    assert port.dtype == want.dtype == np.float32
    assert port.shape == want.shape
    np.testing.assert_array_equal(port, want)


@pytest.mark.parametrize("filt", sorted(FILTERS))
@pytest.mark.parametrize("ctype,depth", PNG_MODES, ids=[f"ct{c}_d{d}" for c, d in PNG_MODES])
def test_png_decoder_equals_jax(tmp_path, ctype, depth, filt):
    rng = np.random.default_rng(ctype * 100 + depth)
    samples, palette = _png_samples(rng, ctype, depth)
    path = str(tmp_path / "x.png")
    write_png(path, samples, ctype, depth, FILTERS[filt], palette)
    _same(image._read_image(path), jimage._read_image(path))


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "LA", "P", "I;16", "1"])
def test_png_written_by_pillow_equals_jax(tmp_path, mode):
    rng = np.random.default_rng(len(mode))
    rgba = rng.integers(0, 256, (19, 23, 4), dtype=np.uint8)
    if mode == "I;16":
        im = Image.fromarray(rng.integers(0, 65536, (19, 23), dtype=np.uint16))
    elif mode == "1":
        im = Image.fromarray(rgba[..., 0] > 127)
    else:
        im = Image.fromarray(rgba, "RGBA").convert(mode)
    path = str(tmp_path / "p.png")
    im.save(path)
    _same(image._read_image(path), jimage._read_image(path))


def test_png_written_by_matplotlib_equals_jax(tmp_path):
    import matplotlib.image as mpimg

    path = str(tmp_path / "m.png")
    mpimg.imsave(path, np.random.default_rng(5).integers(0, 256, (9, 11, 3), dtype=np.uint8))
    _same(image._read_image(path), jimage._read_image(path))


@pytest.mark.parametrize("bits", [24, 32])
@pytest.mark.parametrize("top_down", [False, True], ids=["bottom_up", "top_down"])
@pytest.mark.parametrize("width", [5, 8])
def test_bmp_decoder_equals_jax(tmp_path, bits, top_down, width):
    rng = np.random.default_rng(bits + width)
    rgb = rng.integers(0, 256, (6, width, 3), dtype=np.uint8)
    path = str(tmp_path / "x.bmp")
    write_bmp(path, rgb, bits, top_down, fourth=rng.integers(0, 256, (6, width, 1),
                                                             dtype=np.uint8))
    _same(image._read_image(path), jimage._read_image(path))
    np.testing.assert_array_equal(image._read_image(path), rgb / np.float32(255))


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_bmp_written_by_pillow_equals_jax(tmp_path, mode):
    rgba = np.random.default_rng(9).integers(0, 256, (7, 10, 4), dtype=np.uint8)
    path = str(tmp_path / "p.bmp")
    Image.fromarray(rgba, "RGBA").convert(mode).save(path)
    _same(image._read_image(path), jimage._read_image(path))


@pytest.mark.parametrize("size", [(7, 10), (1, 1), (13, 33)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", ["L", "P", "1"])
def test_palette_bmp_written_by_pillow_equals_jax(tmp_path, mode, size):
    """1- and 8-bit BMP with a colour table, in each mode Pillow reads them
    back in: a grey ramp (L), 0 and 255 (1) and any other table (P, at
    256, 7 and 2 colours)."""
    rng = np.random.default_rng(size[0] * 100 + size[1])
    rgb = Image.fromarray(rng.integers(0, 256, (*size, 3), dtype=np.uint8))
    ims = ([rgb.quantize(colors=n) for n in (256, 7, 2)] if mode == "P"
           else [rgb.convert(mode)])
    for i, im in enumerate(ims):
        path = str(tmp_path / f"{mode}{i}.bmp")
        im.save(path)
        with Image.open(path) as back:
            assert back.mode == mode
        got = image._read_image(path)
        _same(got, jimage._read_image(path))
        assert got.shape == (*size, 1 if mode == "L" else 3)


@pytest.mark.parametrize("mode", ["RGB", "L"])
def test_jpeg_through_pillow_equals_jax(tmp_path, mode):
    rgb = np.random.default_rng(11).integers(0, 256, (16, 12, 3), dtype=np.uint8)
    path = str(tmp_path / "j.jpg")
    Image.fromarray(rgb).convert(mode).save(path, quality=90)
    _same(image._read_image(path), jimage._read_image(path))


def test_jpeg_without_pillow_raises_naming_file_and_decoder(tmp_path, monkeypatch):
    path = str(tmp_path / "j.jpeg")
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(path)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ValueError, match="Pillow") as err:
        image._read_image(path)
    assert path in str(err.value)


def test_interlaced_png_and_other_formats_raise(tmp_path):
    samples, _ = _png_samples(np.random.default_rng(0), 2, 8)
    path = str(tmp_path / "i.png")
    write_png(path, samples, 2, 8, [0], interlace=1)
    with pytest.raises(ValueError, match="interlaced") as err:
        image._read_image(path)
    assert path in str(err.value)
    gif = str(tmp_path / "g.png")
    Image.fromarray(np.zeros((4, 4), np.uint8)).save(gif, format="GIF")
    with pytest.raises(ValueError, match="not a PNG, BMP or JPEG"):
        image._read_image(gif)
    bmp = str(tmp_path / "b.bmp")
    Image.fromarray(np.zeros((4, 4), np.uint8)).convert("P").save(bmp)  # 8-bit palette
    _same(image._read_image(bmp), jimage._read_image(bmp))  # read now, as JAX reads it
    rle = bytearray(open(bmp, "rb").read())
    rle[30:34] = struct.pack("<I", 1)  # BI_RLE8
    open(bmp, "wb").write(bytes(rle))
    with pytest.raises(ValueError, match="compression 1"):
        image._read_image(bmp)


def test_resize_nearest_equals_jax():
    img = np.random.default_rng(1).random((9, 14, 3)).astype(np.float32)
    for hw in ((9, 14), (4, 5), (20, 31)):
        np.testing.assert_array_equal(image._resize_nearest(img, *hw),
                                      jimage._resize_nearest(img, *hw))
    assert image.IMAGE_EXTENSIONS == jimage.IMAGE_EXTENSIONS


# -- a mixed image tree ------------------------------------------------------

# (split, class, count); "d" first appears in valid, so the class index grows
TREE = [("train", "a", 6), ("train", "b", 6), ("train", "c", 6),
        ("valid", "b", 3), ("valid", "d", 3), ("test", "a", 2), ("test", "c", 2), ("test", "d", 2)]
SIZES = [(20, 20), (24, 18), (15, 30), (30, 15), (20, 22)]


def _write_tree(root, seed=3):
    """PNG (the local writer's colour types and filters, Pillow's modes),
    BMP and JPEG images of mixed sizes and orientations; the first image is
    a 20 x 20 RGB PNG, and each class has its own brightness."""
    rng = np.random.default_rng(seed)
    k = 0
    for split, cls, n in TREE:
        d = root / split / cls
        d.mkdir(parents=True)
        base = {"a": 40, "b": 110, "c": 170, "d": 220}[cls]
        for i in range(n):
            h, w = SIZES[k % len(SIZES)]
            rgb = np.clip(base + rng.normal(0, 30, (h, w, 3)), 0, 255).astype(np.uint8)
            kind = k % 6
            path = d / f"{i:03d}"
            if k == 0 or kind == 0:
                write_png(f"{path}.png", rgb, 2, 8, [0, 1, 2, 3, 4])
            elif kind == 1:
                write_png(f"{path}.png", rgb[..., :1], 0, 8, [4, 3])
            elif kind == 2:
                alpha = rng.integers(0, 256, (h, w, 1))
                write_png(f"{path}.png", np.concatenate([rgb, alpha], 2), 6, 8, [1, 2])
            elif kind == 3:
                Image.fromarray(rgb).convert("L").save(f"{path}.png")
            elif kind == 4:
                write_bmp(f"{path}.bmp", rgb, 24, k % 2 == 0)
            else:
                Image.fromarray(rgb).save(f"{path}.jpg", quality=95)
            k += 1
    (root / "train" / "empty").mkdir()  # a class without samples does not exist
    (root / "train" / "a" / "notes.txt").write_text("not an image")
    return str(root)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return _write_tree(tmp_path_factory.mktemp("tree"))


LOADER_CASES = {
    "rgb_inferred": dict(minibatch_size=5),
    "gray_mean_disp": dict(grayscale=True, target_shape=(16, 16), normalization="mean_disp",
                           normalization_fit_samples=7, minibatch_size=4),
    "rgb_linear": dict(target_shape=(12, 14, 3), normalization="linear", minibatch_size=7),
    "gray_target_range": dict(target_shape=(10, 10, 1), normalization="range",
                              normalization_kwargs={"scale": 2.0, "shift": -0.25},
                              minibatch_size=8),
    "no_shuffle": dict(target_shape=(8, 8), shuffle=False, minibatch_size=6),
}


@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_image_directory_loader_equals_jax(tree, case):
    kw = LOADER_CASES[case]
    _seed_both()
    jl, tl = jimage.ImageDirectoryLoader(tree, **kw), ImageDirectoryLoader(tree, **kw)
    assert tl.classes == jl.classes == ["a", "b", "c", "d"]
    assert tl.index == jl.index
    assert tl.target_shape == jl.target_shape and tl.sample_shape == jl.sample_shape
    assert tl.class_lengths == jl.class_lengths == {"train": 18, "valid": 6, "test": 6}
    assert tl.normalizer.keys() == jl.normalizer.keys()
    for key, value in jl.normalizer.items():
        np.testing.assert_array_equal(tl.normalizer[key], value)
    for split in ("train", "valid", "test"):
        np.testing.assert_array_equal(tl.split_labels(split), jl.split_labels(split))
    for _ in range(2):
        got, want = list(tl.epoch()), list(jl.epoch())
        assert [s for s, _ in got] == [s for s, _ in want]
        for (_, mt), (_, mj) in zip(got, want):
            for field in ("data", "labels", "mask", "indices"):
                a, b = getattr(mt, field), np.asarray(getattr(mj, field))
                assert a.dtype == b.dtype, field
                np.testing.assert_array_equal(a, b, err_msg=field)


def test_pack_image_dir_writes_jax_bytes(tree, tmp_path):
    counts = pack_image_dir(tree, str(tmp_path / "port"), size=12)
    assert counts == jimagenet.pack_image_dir(tree, str(tmp_path / "jax"), size=12)
    assert counts == {"train": 18, "valid": 6, "test": 6}
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    assert set(names) >= {"train_images.npy", "classes.json", "mean_rgb.json"}
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


@pytest.mark.parametrize("size", [9, 16, 31])
def test_pack_helpers_equal_jax(size):
    rng = np.random.default_rng(size)
    for hw in ((20, 20), (15, 31), (31, 15), (7, 9)):
        for c in (1, 3):
            img = rng.random(hw + (c,)).astype(np.float32)
            for fn in ("_resize_short_side", "_center_crop", "_to_u8_rgb"):
                want = getattr(jimagenet, fn)(img, min(size, *hw) if fn == "_center_crop" else size)
                got = getattr(timagenet, fn)(img, min(size, *hw) if fn == "_center_crop" else size)
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want, err_msg=fn)
            assert timagenet._to_u8_rgb(img, size).shape == (size, size, 3)


def _crop_inputs(seed=0, n=6, h=20, w=18, b=9, ch=11, cw=7):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    idx = rng.integers(0, n, b)
    oy = rng.integers(0, h - ch + 1, b)
    ox = rng.integers(0, w - cw + 1, b)
    flip = rng.integers(0, 2, b).astype(np.uint8)
    return data, idx, oy, ox, flip, ch, cw


def test_crop_gather_native_and_numpy_equal_jax():
    args = _crop_inputs()
    got = native.crop_gather_u8(*args)
    assert got.dtype == np.uint8 and got.shape == (9, 11, 7, 3)
    np.testing.assert_array_equal(got, native.crop_gather_u8_reference(*args))
    np.testing.assert_array_equal(got, jnative.crop_gather_u8(*args))
    assert native.build().path.parent == native.BUILD_DIR


def test_crop_gather_from_a_memmap_and_a_strided_view_equal_jax(tmp_path):
    data, *rest = _crop_inputs(1)
    np.save(tmp_path / "d.npy", data)
    mm = np.load(tmp_path / "d.npy", mmap_mode="r")
    np.testing.assert_array_equal(native.crop_gather_u8(mm, *rest), jnative.crop_gather_u8(mm, *rest))
    view = np.concatenate([data, data], axis=2)[:, :, ::2]  # not C-contiguous
    np.testing.assert_array_equal(native.crop_gather_u8(view, *rest),
                                  jnative.crop_gather_u8(view, *rest))


@pytest.mark.parametrize("bad", ["index_past_n", "negative_index", "oy_past_edge", "negative_ox"])
def test_crop_gather_refuses_out_of_bounds(bad):
    data, idx, oy, ox, flip, ch, cw = _crop_inputs(2)
    if bad == "index_past_n":
        idx = idx.copy(); idx[3] = len(data)
    elif bad == "negative_index":
        idx = idx.copy(); idx[0] = -1
    elif bad == "oy_past_edge":
        oy = oy.copy(); oy[1] = data.shape[1] - ch + 1
    else:
        ox = ox.copy(); ox[2] = -1
    for fn in (native.crop_gather_u8, native.crop_gather_u8_reference, jnative.crop_gather_u8):
        with pytest.raises(IndexError):
            fn(data, idx, oy, ox, flip, ch, cw)


def test_failed_native_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    src = tmp_path / "broken.cc"
    src.write_text("int f( {\n")
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        native.build()
    assert "error" in str(err.value)


@pytest.fixture(scope="module")
def packed(tree, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("packed"))
    pack_image_dir(tree, out, size=16)
    return out


@pytest.mark.parametrize("random_flip", [True, False], ids=["flip", "no_flip"])
def test_imagenet_loader_batches_equal_jax(packed, random_flip):
    kw = dict(crop_size=12, minibatch_size=5, random_flip=random_flip)
    _seed_both()
    jl, tl = jimagenet.ImageNetLoader(packed, **kw), ImageNetLoader(packed, **kw)
    assert tl.n_classes() == jl.n_classes() == 4
    assert tl.sample_shape == jl.sample_shape == (12, 12, 3)
    assert tl.class_lengths == jl.class_lengths
    np.testing.assert_array_equal(tl.mean_rgb, jl.mean_rgb)
    for split in ("train", "valid", "test"):
        np.testing.assert_array_equal(tl.split_labels(split), jl.split_labels(split))
    for _ in range(2):
        got, want = list(tl.epoch()), list(jl.epoch())
        assert [s for s, _ in got] == [s for s, _ in want]
        for (_, mt), (_, mj) in zip(got, want):
            assert mt.data.dtype == np.uint8
            for field in ("data", "labels", "mask", "indices"):
                np.testing.assert_array_equal(getattr(mt, field), getattr(mj, field))
    x = got[0][1].data
    np.testing.assert_allclose(
        tl.device_preproc()(torch.from_numpy(x)).numpy(),
        np.asarray(jl.device_preproc()(jax.numpy.asarray(x), None)), rtol=1e-6, atol=1e-7)


def test_imagenet_loader_packs_a_raw_tree_as_jax(tree, tmp_path):
    for side in ("port", "jax"):
        shutil.copytree(tree, tmp_path / side)
    _seed_both()
    jl = jimagenet.ImageNetLoader(str(tmp_path / "jax"), pack_size=14, crop_size=10,
                                  minibatch_size=4)
    tl = ImageNetLoader(str(tmp_path / "port"), pack_size=14, crop_size=10, minibatch_size=4)
    assert tl.data_dir == str(tmp_path / "port" / ".packed14")
    for name in sorted(os.listdir(tmp_path / "jax" / ".packed14")):
        assert (tmp_path / "port" / ".packed14" / name).read_bytes() == (
            tmp_path / "jax" / ".packed14" / name).read_bytes()
    for (_, mt), (_, mj) in zip(tl.epoch(), jl.epoch()):
        np.testing.assert_array_equal(mt.data, mj.data)
    with pytest.raises(ValueError, match="exceeds packed image size"):
        ImageNetLoader(str(tmp_path / "port"), pack_size=14, crop_size=15)


def test_imagenet_loader_classes_from_labels_without_classes_json(packed, tmp_path):
    for name in os.listdir(packed):
        if name != "classes.json":
            shutil.copy(os.path.join(packed, name), tmp_path / name)
    assert ImageNetLoader(str(tmp_path), crop_size=12).n_classes() == 3  # train: a, b, c


@pytest.mark.parametrize(
    "make",
    [
        lambda tree, packed: ImageNetLoader(packed, crop_size=12, pool_sharded=True),
        lambda tree, packed: FullBatchLoader({"train": np.zeros((4, 2))}, pool_sharded=True),
    ],
    ids=["pool_sharded", "fullbatch_pool_sharded"],
)
def test_unported_loader_keywords_name_their_roadmap_item(tree, packed, make):
    with pytest.raises(NotImplementedError, match="not ported") as err:
        make(tree, packed)
    _names_its_item(str(err.value))


def _fullbatch_pair(**kw):
    """The same labelled u8 data in the port's and the JAX package's
    FullBatch loader (three splits, four classes of unequal sizes)."""
    rng = np.random.default_rng(3)
    data = {s: rng.integers(0, 256, (n, 5, 5, 1), dtype=np.uint8)
            for s, n in (("train", 23), ("valid", 6), ("test", 9))}
    labels = {s: rng.choice(4, len(v), p=[0.5, 0.25, 0.15, 0.1]).astype(np.int32)
              for s, v in data.items()}
    kw = dict(minibatch_size=4, normalization="range", **kw)
    return FullBatchLoader(data, labels, **kw), JaxFullBatch(data, labels, **kw)


@pytest.mark.parametrize(
    "make",
    [
        lambda packed: (ImageNetLoader(packed, crop_size=12, minibatch_size=5,
                                       device_resident=True),
                        jimagenet.ImageNetLoader(packed, crop_size=12, minibatch_size=5,
                                                 device_resident=True)),
        lambda packed: (ImageNetLoader(packed, crop_size=12, minibatch_size=5, balanced=True),
                        jimagenet.ImageNetLoader(packed, crop_size=12, minibatch_size=5,
                                                 balanced=True)),
        lambda packed: _fullbatch_pair(balanced=True),
        lambda packed: _fullbatch_pair(device_resident=True),
    ],
    ids=["device_resident", "balanced", "fullbatch_balanced", "fullbatch_device_resident"],
)
def test_lifted_loader_keywords_match_jax(packed, make):
    """The keywords refused until the device pool and balanced shuffling
    were ported: each loader serves the JAX package's batches exactly (the
    same orders from the same seed, the same index payloads and the same
    pool), two epochs long."""
    _seed_both()
    tl, jl = make(packed)
    for _ in range(2):
        got, want = list(tl.epoch()), list(jl.epoch())
        assert [s for s, _ in got] == [s for s, _ in want]
        for (_, mt), (_, mj) in zip(got, want):
            for field in ("data", "labels", "mask", "indices"):
                np.testing.assert_array_equal(getattr(mt, field), getattr(mj, field))
    tc, jc = tl.device_context(), jl.device_context()
    assert (tc is None) == (jc is None)
    if tc is not None:
        np.testing.assert_array_equal(tc["pool"], jc["pool"])
        assert tl.epoch_scan_friendly and jl.epoch_scan_friendly


@pytest.mark.parametrize("kwargs", [{"skip_bad_batches": True, "fetch_retries": 0},
                                    {"fetch_retries": 5, "fetch_backoff_s": 0.0}],
                         ids=["skip_bad_batches", "fetch_retries"])
def test_fetch_ladder_keywords_are_honoured(tree, kwargs):
    """The retry and skip ladder, refused until the port had it: a decode
    that fails once is retried, or its batch skipped."""
    from znicz_tpu_torch.utils import faults

    ref = [mb.data for mb in ImageDirectoryLoader(tree, minibatch_size=8).batches("train",
                                                                                  shuffle=False)]
    loader = ImageDirectoryLoader(tree, minibatch_size=8, **kwargs)
    with faults.injected("loader.fetch_flaky", times=1):
        got = [mb.data for mb in loader.batches("train", shuffle=False)]
    if kwargs.get("skip_bad_batches"):
        assert len(got) == len(ref) - 1  # the first batch was skipped
        pairs = zip(got, ref[1:])
    else:
        pairs = zip(got, ref)
        assert len(got) == len(ref)
    for a, b in pairs:
        np.testing.assert_array_equal(a, b)


def test_loader_keywords_at_jax_defaults_are_taken(packed):
    import inspect

    from znicz_tpu.loader.base import Loader as JaxLoader

    kw = {n: p.default for n, p in inspect.signature(JaxLoader.__init__).parameters.items()
          if p.kind is inspect.Parameter.KEYWORD_ONLY}
    loader = ImageNetLoader(packed, crop_size=12, **kw)
    assert loader.max_minibatch_size == kw["minibatch_size"]
    ref = JaxFullBatch({"train": np.zeros((4, 2), np.float32)}, **kw)
    assert FullBatchLoader({"train": np.zeros((4, 2), np.float32)}, **kw).max_minibatch_size == (
        ref.max_minibatch_size)
    # FullBatchLoader's own keywords (device_resident, pool_sharded, ...)
    fb = {n: p.default for n, p in inspect.signature(JaxFullBatch.__init__).parameters.items()
          if p.kind is inspect.Parameter.KEYWORD_ONLY}
    assert {"device_resident", "pool_sharded"} <= set(fb)
    assert FullBatchLoader({"train": np.zeros((4, 2), np.float32)}, **fb).class_lengths == (
        {"train": 4})


# -- the image-tree models, 2 epochs against JAX --------------------------------

SMALL_ALEXNET = [
    {"type": "conv_relu", "->": {"n_kernels": 8, "kx": 5, "ky": 5, "sliding": (2, 2)},
     "<-": {"learning_rate": 0.01, "gradient_moment": 0.9}},
    {"type": "norm", "->": {"n": 5}},
    {"type": "max_pooling", "->": {"kx": 3, "ky": 3, "sliding": (2, 2)}},
    {"type": "conv_relu", "->": {"n_kernels": 16, "kx": 3, "ky": 3, "padding": (1, 1, 1, 1)},
     "<-": {"learning_rate": 0.01, "gradient_moment": 0.9}},
    {"type": "norm", "->": {"n": 5}},
    {"type": "max_pooling", "->": {"kx": 3, "ky": 3, "sliding": (2, 2)}},
    {"type": "all2all_relu", "->": {"output_sample_shape": 32},
     "<-": {"learning_rate": 0.01, "gradient_moment": 0.9}},
    {"type": "softmax", "->": {"output_sample_shape": 1000},
     "<-": {"learning_rate": 0.01, "gradient_moment": 0.9}},
]
# name: (port module, JAX module, its root node, root overrides ("tree": a
# copy of the image tree), extra build kwargs)
MODELS = {
    "kanji_synthetic": (kanji, jax_kanji, "kanji", {"loader": {"n_train": 300, "n_test": 100}},
                        {}),
    "yale_faces_synthetic": (yale_faces, jax_yale, "yale_faces",
                             {"loader": {"n_train": 200, "n_test": 60}}, {}),
    "kanji_tree": (kanji, jax_kanji, "kanji", {"loader": {"data_dir": "tree", "minibatch_size": 7}},
                   {}),
    "alexnet_data_dir": (alexnet, jax_alexnet, "alexnet", {
        "loader": {"data_dir": "tree", "pack_size": 32, "image_size": 27, "minibatch_size": 8},
        "layers": SMALL_ALEXNET,
    }, {"compute_dtype": None}),
}


@pytest.fixture(scope="module", params=sorted(MODELS))
def runs(request, tree, tmp_path_factory):
    name = request.param
    tmod, jmod, node, over, extra = MODELS[name]
    saved = (jroot.to_dict(), troot.to_dict())
    dirs = {}
    for side in ("jax", "port"):  # each packs its own copy of a raw tree
        dirs[side] = str(tmp_path_factory.mktemp(f"{name}_{side}") / "tree")
        shutil.copytree(tree, dirs[side])
    _seed_both()
    try:
        for root, side in ((jroot, "jax"), (troot, "port")):
            o = json.loads(json.dumps(over))
            if o.get("loader", {}).get("data_dir") == "tree":
                o["loader"]["data_dir"] = dirs[side]
            getattr(root, node).update(o)
        dc = {"max_epochs": 2}
        jwf = jmod.build_workflow(prefetch_batches=0, decision_config=dc, **extra)
        twf = tmod.build_workflow(device="cpu", decision_config=dc, **extra)
    finally:
        for root, t in zip((jroot, troot), saved):
            root.clear()
            root.update(t)
    out = {"name": name, "jax_init": jax.device_get(jwf.model.params),
           "torch_init": model_lib.params_to_numpy(twf.model.params),
           "jax_epochs": [], "torch_epochs": [], "shapes": (jwf.model.output_shape,
                                                            twf.model.output_shape)}
    jwf.initialize()
    twf.initialize()
    for _ in range(2):
        out["jax_epochs"].append(jwf.run_epoch()["summary"])
        out["torch_epochs"].append(twf.run_epoch()["summary"])
    out["jax_final"] = jax.device_get(jwf.state.params)
    out["torch_final"] = model_lib.params_to_numpy(twf.state.params)
    out["torch_loader"] = twf.loader
    tprng.reset()
    return out


def test_model_init_and_head_equal_jax(runs):
    assert runs["shapes"][0] == runs["shapes"][1]
    if runs["name"] in ("kanji_tree", "alexnet_data_dir"):
        assert runs["shapes"][1] == (4,)  # the tree's four classes
    if runs["name"] == "alexnet_data_dir":
        assert isinstance(runs["torch_loader"], ImageNetLoader)
    for lj, lt in zip(runs["jax_init"], runs["torch_init"]):
        assert lj.keys() == lt.keys()
        for k in lj:
            np.testing.assert_array_equal(lt[k], np.asarray(lj[k]))


def test_model_epochs_equal_jax(runs):
    for ej, et in zip(runs["jax_epochs"], runs["torch_epochs"]):
        assert et.keys() == ej.keys()
        for split in ej:
            assert et[split]["n_samples"] == ej[split]["n_samples"]
            for key in ("loss", "n_err"):
                np.testing.assert_allclose(et[split][key], ej[split][key], rtol=RTOL_EPOCH,
                                           err_msg=f"{runs['name']} {split} {key}")


def test_model_final_weights_equal_jax(runs):
    for lj, lt in zip(runs["jax_final"], runs["torch_final"]):
        for k in lj:
            np.testing.assert_allclose(lt[k], np.asarray(lj[k]), rtol=RTOL_W, atol=ATOL_W)
