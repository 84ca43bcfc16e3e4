"""The native crop gather of the ImageNet loader (port of the part of
``znicz_tpu/loader/native.py`` that ``loader/imagenet.py`` uses).

``crop_gather_u8`` runs ``crop_gather_u8`` of ``native/batch_assembler.cc``
(a thread-parallel memcpy of each crop window, reversed along W for a
flip), which is compiled with ``g++`` at first use into ``build/native/``
at the repository root, under a name keyed by the hash of the source and
the flags, and loaded with ctypes.  A failed build raises with the
compiler's output: there is no fallback.  :func:`crop_gather_u8_reference`
is the plain numpy window copy; the loader uses it only for data that is
not C-contiguous uint8, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np

REPO = Path(__file__).resolve().parents[2]
SOURCE = REPO / "native" / "batch_assembler.cc"
BUILD_DIR = REPO / "build" / "native"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")


class Built(NamedTuple):
    path: Path  # the shared library
    seconds: float  # g++'s wall time; 0.0 when the library was there already


def build() -> Built:
    """Compile ``native/batch_assembler.cc`` into ``build/native/`` unless
    the library of this source and these flags is there already."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libbatch_assembler-{digest}.so"
    if lib.exists():
        return Built(lib, 0.0)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{lib.name}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            ["g++", *FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True, timeout=300,
        )
    except OSError as exc:
        raise RuntimeError(f"g++ could not run to build {SOURCE}: {exc}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ failed on {SOURCE} (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)  # atomic: a reader never sees a partial library
    return Built(lib, time.perf_counter() - t0)


@functools.cache
def load() -> ctypes.CDLL:
    """The built library (building it first if needed), loaded once."""
    lib = ctypes.CDLL(str(build().path))
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.crop_gather_u8.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        i64p, i64p, i64p, u8p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, u8p,
    ]
    lib.crop_gather_u8.restype = None
    return lib


def _check_indices(indices: np.ndarray, n: int) -> np.ndarray:
    """The C side does raw pointer arithmetic: refuse what numpy would refuse
    (and the negatives numpy would wrap) before crossing into it."""
    idx = np.ascontiguousarray(indices, np.int64)
    if idx.size and (idx.min() < 0 or idx.max() >= n):
        raise IndexError(f"indices out of range [0, {n}): min={idx.min()} max={idx.max()}")
    return idx


def _crop_args(data, indices, oy, ox, flip, out_h, out_w):
    n, h, w, _ = data.shape
    idx = _check_indices(indices, n)
    oy = np.ascontiguousarray(oy, np.int64)
    ox = np.ascontiguousarray(ox, np.int64)
    if oy.min(initial=0) < 0 or ox.min(initial=0) < 0 or (
        idx.size and (oy.max(initial=0) > h - out_h or ox.max(initial=0) > w - out_w)
    ):
        raise IndexError("crop window out of image bounds")
    return idx, oy, ox, np.ascontiguousarray(flip, np.uint8)


def crop_gather_u8_reference(data, indices, oy, ox, flip, out_h: int, out_w: int) -> np.ndarray:
    """The plain version: a numpy copy of each window, W reversed on a flip."""
    idx, oy, ox, flip = _crop_args(data, indices, oy, ox, flip, out_h, out_w)
    out = np.empty((len(idx), out_h, out_w, data.shape[3]), data.dtype)
    for i, j in enumerate(idx):
        win = data[j, oy[i]:oy[i] + out_h, ox[i]:ox[i] + out_w]
        out[i] = win[:, ::-1] if flip[i] else win
    return out


def crop_gather_u8(data, indices, oy, ox, flip, out_h: int, out_w: int) -> np.ndarray:
    """Gather, crop and optionally flip packed images: ``data`` ``[N, H, W,
    C]`` u8 (a memmap too: the C side reads through page faults); sample i
    is the ``(out_h, out_w)`` window at ``(oy[i], ox[i])`` of image
    ``indices[i]``, W reversed when ``flip[i]``.  The output stays u8."""
    if data.dtype != np.uint8 or not data.flags["C_CONTIGUOUS"]:
        return crop_gather_u8_reference(data, indices, oy, ox, flip, out_h, out_w)
    idx, oy, ox, flip = _crop_args(data, indices, oy, ox, flip, out_h, out_w)
    _, h, w, c = data.shape
    out = np.empty((len(idx), out_h, out_w, c), np.uint8)
    load().crop_gather_u8(
        data.reshape(-1), h, w, c, idx, oy, ox, flip, len(idx), out_h, out_w, out.reshape(-1)
    )
    return out
