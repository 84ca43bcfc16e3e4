"""The device-resident pool and the native row gathers against the JAX
package, on the CPU.

The pool's layout (``pool_offsets``/``pool_concat``), the FullBatch and
packed-ImageNet index payloads, the gathers and crops the step cuts from the
pool (and their float32 conversion, JAX's op by op), class-balanced
shuffling and the three native row gathers.  Inputs come from numpy seeds
and the shared named numpy streams.  Every comparison is exact: the same
integer and byte arithmetic, the same float32 operations in the same
order, the same numpy stream draws, the same C loops.
"""

import numpy as np
import pytest
import torch

from znicz_tpu.core import prng as jprng
from znicz_tpu.loader import base as jbase, imagenet as jimagenet, native as jnative
from znicz_tpu.loader.fullbatch import FullBatchLoader as JaxLoader
from znicz_tpu_torch.core import prng as tprng
from znicz_tpu_torch.loader import base, imagenet, native
from znicz_tpu_torch.loader.fullbatch import FullBatchLoader

SEED = 13


def _seed_both():
    for reg in (jprng, tprng):
        reg.reset()
        reg.seed_all(SEED)


def _splits(dtype=np.uint8, shape=(4, 4, 3)):
    rng = np.random.default_rng(1)
    sizes = {"train": 21, "valid": 5, "test": 8}
    if dtype == np.uint8:
        data = {s: rng.integers(0, 256, (n,) + shape, dtype=np.uint8) for s, n in sizes.items()}
    else:
        data = {s: rng.normal(0, 1, (n,) + shape).astype(dtype) for s, n in sizes.items()}
    labels = {s: rng.integers(0, 3, n).astype(np.int32) for s, n in sizes.items()}
    return data, labels


def test_pool_layout_matches_jax():
    data, _ = _splits()
    assert base.pool_offsets(data) == jbase.pool_offsets(data) == {
        "test": 0, "train": 8, "valid": 29}
    np.testing.assert_array_equal(base.pool_concat(data), jbase.pool_concat(data))
    pool = base.pool_concat(data)
    for split, off in base.pool_offsets(data).items():
        np.testing.assert_array_equal(pool[off:off + len(data[split])], data[split])


CASES = {
    "u8_range": dict(normalization="range",
                     normalization_kwargs={"scale": 255.0, "shift": -0.5}),
    "f32_mean_disp": dict(normalization="mean_disp"),
    "f32_none": dict(),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fullbatch_pool_payloads_and_gathers_match_jax(case):
    """The device context, each batch's int32 payload (rows plus the
    split's pool offset) and the step's gather (and u8 conversion) from the
    pool."""
    data, labels = _splits(np.uint8 if case == "u8_range" else np.float32)
    kw = dict(minibatch_size=6, device_resident=True, **CASES[case])
    _seed_both()
    tl, jl = FullBatchLoader(data, labels, **kw), JaxLoader(data, labels, **kw)
    assert tl.epoch_scan_friendly and jl.epoch_scan_friendly
    tpool, jpool = tl.device_context()["pool"], jl.device_context()["pool"]
    assert tpool.dtype == jpool.dtype
    np.testing.assert_array_equal(tpool, jpool)
    pre_t, pre_j = tl.device_preproc(), jl.device_preproc()
    ctx_t, ctx_j = {"pool": torch.from_numpy(tpool)}, {"pool": jpool}
    for _ in range(2):
        for (st, mt), (sj, mj) in zip(tl.epoch(), jl.epoch()):
            assert st == sj and mt.data.dtype == np.int32
            for field in ("data", "labels", "mask", "indices"):
                np.testing.assert_array_equal(getattr(mt, field), getattr(mj, field))
            got = pre_t(torch.from_numpy(mt.data), ctx_t).numpy()
            want = np.asarray(pre_j(mj.data, ctx_j))
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
            # the pool rows are the split's own samples
            host = tl.data[st][mt.indices]
            if case != "u8_range":
                np.testing.assert_array_equal(got, host)


@pytest.mark.parametrize("device_convert", [False, True], ids=["host_u8", "device_u8"])
def test_fullbatch_host_path_takes_the_native_gathers_as_jax(device_convert):
    """u8 data under "range" stays u8 on the host; each batch is gathered by
    the native code (converted there, or shipped u8 for the device), the
    JAX package's batches bit for bit."""
    data, labels = _splits()
    kw = dict(minibatch_size=6, normalization="range", device_convert=device_convert)
    _seed_both()
    tl, jl = FullBatchLoader(data, labels, **kw), JaxLoader(data, labels, **kw)
    assert tl.data["train"].dtype == np.uint8
    for (_, mt), (_, mj) in zip(tl.epoch(), jl.epoch()):
        assert mt.data.dtype == mj.data.dtype == (np.uint8 if device_convert else np.float32)
        np.testing.assert_array_equal(mt.data, mj.data)


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    """A packed split set as ``pack_image_dir`` writes it: u8 ``[n, 16, 16,
    3]`` images per split, labels, classes and the train mean."""
    import json

    out = tmp_path_factory.mktemp("packed")
    rng = np.random.default_rng(2)
    for split, n in (("train", 13), ("valid", 4), ("test", 6)):
        np.save(out / f"{split}_images.npy", rng.integers(0, 256, (n, 16, 16, 3), dtype=np.uint8))
        np.save(out / f"{split}_labels.npy", rng.integers(0, 3, n).astype(np.int32))
    (out / "classes.json").write_text(json.dumps(["a", "b", "c"]))
    (out / "mean_rgb.json").write_text(json.dumps([0.4, 0.5, 0.6]))
    return str(out)


@pytest.mark.parametrize("random_flip", [True, False], ids=["flip", "no_flip"])
def test_imagenet_pool_payloads_and_crops_match_jax(packed, random_flip):
    """The packed pool, each batch's ``[B, 4]`` payload (pool row, oy, ox,
    flip) from the same draws, the crops cut from the pool equal to the host
    native crops bitwise, and the normalized batch JAX's."""
    kw = dict(crop_size=11, minibatch_size=5, random_flip=random_flip)
    _seed_both()
    tl = imagenet.ImageNetLoader(packed, device_resident=True, **kw)
    jl = jimagenet.ImageNetLoader(packed, device_resident=True, **kw)
    host = imagenet.ImageNetLoader(packed, **kw)  # the host native crops
    assert tl.epoch_scan_friendly
    tpool, jpool = tl.device_context()["pool"], jl.device_context()["pool"]
    np.testing.assert_array_equal(tpool, jpool)
    pool_t = torch.from_numpy(tpool)
    pre_t, pre_j = tl.device_preproc(), jl.device_preproc()
    flips = 0
    for _ in range(2):
        tprng.reset()
        tprng.seed_all(SEED)
        want_host = list(host.epoch())
        tprng.reset()
        tprng.seed_all(SEED)
        jprng.reset()
        jprng.seed_all(SEED)
        for (st, mt), (sj, mj), (_, mh) in zip(tl.epoch(), jl.epoch(), want_host):
            assert st == sj and mt.data.shape == (len(mt.indices), 4)
            np.testing.assert_array_equal(mt.data, mj.data)
            np.testing.assert_array_equal(mt.labels, mj.labels)
            crops = imagenet.crop_from_pool(pool_t, torch.from_numpy(mt.data), 11).numpy()
            assert crops.dtype == np.uint8
            np.testing.assert_array_equal(crops, mh.data)
            flips += int(mt.data[:, 3].sum())
            got = pre_t(torch.from_numpy(mt.data), {"pool": pool_t}).numpy()
            want = np.asarray(pre_j(mj.data, {"pool": jpool}))
            np.testing.assert_array_equal(got, want)
    assert (flips > 0) == random_flip


@pytest.mark.parametrize("n_classes", [2, 5])
def test_balanced_order_matches_jax(n_classes):
    """Class-balanced shuffling draws from the shuffle stream as the JAX
    package does: the same train order every epoch from the same seed."""
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (57, 3)).astype(np.float32)
    y = rng.integers(0, n_classes, 57).astype(np.int32)
    _seed_both()
    kw = dict(minibatch_size=8, balanced=True)
    tl, jl = FullBatchLoader({"train": x}, {"train": y}, **kw), JaxLoader(
        {"train": x}, {"train": y}, **kw)
    assert tl.split_labels("train") is tl.labels["train"]
    for _ in range(3):
        tl.reshuffle()
        jl.reshuffle()
        np.testing.assert_array_equal(tl._order["train"], jl._order["train"])
    # the stream sits where JAX's does
    assert tprng.get("loader").integers(0, 1 << 30) == jprng.get("loader").integers(0, 1 << 30)


def test_balanced_without_labels_is_a_plain_permutation():
    _seed_both()
    x = np.zeros((9, 2), np.float32)
    tl = FullBatchLoader({"train": x}, minibatch_size=4, balanced=True)
    jl = JaxLoader({"train": x}, minibatch_size=4, balanced=True)
    tl.reshuffle()
    jl.reshuffle()
    np.testing.assert_array_equal(tl._order["train"], jl._order["train"])


GATHERS = {
    "gather_rows": (np.float32, {}),
    "gather_rows_u8": (np.uint8, {"scale": 255.0, "shift": -0.5}),
    "gather_rows_u8_raw": (np.uint8, {}),
}


@pytest.mark.parametrize("name", list(GATHERS))
def test_native_gathers_match_jax_bitwise(name):
    """Each native gather against the JAX package's (the same C loop) and
    against its own numpy plain version, bit for bit; out-of-range rows
    raise before the C side."""
    dtype, kw = GATHERS[name]
    rng = np.random.default_rng(6)
    data = (rng.integers(0, 256, (40, 7, 3), dtype=np.uint8) if dtype == np.uint8
            else rng.normal(0, 1, (40, 7, 3)).astype(np.float32))
    idx = rng.integers(0, 40, 17)
    got = getattr(native, name)(data, idx, **kw)
    want = getattr(jnative, name)(data, idx, **kw)
    plain = (native.gather_rows_u8_reference(data, idx, **kw) if name == "gather_rows_u8"
             else native.gather_rows_reference(data, idx))
    assert got.shape == want.shape == (17, 7, 3) and got.dtype == want.dtype == plain.dtype
    assert got.tobytes() == want.tobytes() == plain.tobytes()
    with pytest.raises(IndexError):
        getattr(native, name)(data, np.array([0, 40]), **kw)
    with pytest.raises(IndexError):
        getattr(native, name)(data, np.array([-1]), **kw)
    # a non-contiguous view takes the plain version, the same values
    view = data[::2]
    np.testing.assert_array_equal(getattr(native, name)(view, idx % 20, **kw),
                                  getattr(native, name)(np.ascontiguousarray(view), idx % 20,
                                                        **kw))
