"""Fused Kohonen batch-SOM statistics for Hopper, in CUDA C++.

Replaces the TPU kernel of ``znicz_tpu/ops/pallas/kohonen.py``:
``_accumulate`` (the ``pl.pallas_call`` over ``_accum_kernel``, :93), which
fuses the winner search, the neighbourhood weights and the two
accumulations ``num = h^T x`` and ``den = sum_b h`` of one batch-SOM step.

The kernel is ``znicz_tpu_torch/csrc/kohonen.cu`` (plain C interface, built
with ``nvcc`` for ``sm_90a`` at first use by :mod:`cuda_build`, loaded with
ctypes): one tiled GEMM on the tensor cores in 3xTF32 (``mma.sync``
m16n8k8), launched three times a call: the scores ``x.w^T`` (split along F
into :func:`split_count` pieces when the tiles alone would leave the card
idle), the winners with the neighbourhood table, and ``[num | den] = h^T
[x | 1]`` with ``h`` gathered from that table as the batch rows are loaded.
The partial scores, ``|w|^2``, the winners and the table live between the
launches in scratch that this wrapper allocates with the results in one
block (:func:`_buffers`, shapes from :func:`buffer_shapes`); every sum
runs in a fixed order (no atomics), so the result is the same bits from
run to run.  What bounds it and why it is built so: see the source.  The
three launches are one logical step: ``accumulate.launches`` counts one
per call that reaches the card.  The kernel reads ``2 sigma^2`` through a
pointer to a float32 on the card, so a step captured into a CUDA graph
replays with each step's own value.

Beside it is the plain PyTorch version, :func:`accumulate_reference`, the
CPU path and the kernel's oracle; :func:`accumulate` takes it for CPU
tensors and, for CUDA tensors, launches the kernel or raises.
:func:`train_step` is the fused twin of ``ops/kohonen.py::train_step``, as
``ops/pallas/kohonen.py::train_step`` is in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from znicz_tpu_torch.ops.kernels import cuda_build
from znicz_tpu_torch.ops.kohonen import two_sigma_sq


def pairwise_d2(coords: torch.Tensor) -> torch.Tensor:
    """``[M, M]`` squared grid distances between the map's units (fixed for
    a map: compute it once and pass it along)."""
    return torch.sum(torch.square(coords[:, None, :] - coords[None, :, :]), dim=-1)


# -- the plain PyTorch version (CPU path and the kernel's oracle) ---------------

def sigma_tensor(sigma, device) -> torch.Tensor:
    """``2 sigma^2`` of a host ``sigma`` as the kernel reads it: a one-value
    float32 tensor on ``device``."""
    return torch.tensor(two_sigma_sq(sigma), dtype=torch.float32, device=device)


def accumulate_reference(w, x, mask, d2m, tss, *, win=None):
    """``(num [M, F], den [M, 1])`` as ``_accum_kernel`` computes them:
    winners ``argmax(x.w^T - |w|^2 / 2)`` (or ``win``, given), then
    ``h = exp(-d2m[win] / tss) * mask`` and its two sums; ``tss`` is ``2
    sigma^2``, a one-value float32 tensor (:func:`sigma_tensor`)."""
    if win is None:
        scores = x @ w.T - 0.5 * torch.sum(w * w, dim=1)[None, :]
        win = torch.argmax(scores, dim=1)
    neigh = torch.exp(-d2m / tss)  # [M, M]
    h = neigh[win.long()] * mask[:, None]  # [B, M]
    return h.T @ x, torch.sum(h, dim=0)[:, None]


def _apply_update(w, num, den, learning_rate):
    """``w + lr (num / den - w)`` where ``den > 1e-8``, else ``w``
    (``ops/pallas/kohonen.py:119-122``); ``learning_rate`` is a 0-d float32
    tensor on ``w``'s device or a host scalar, taken in float32."""
    lr = learning_rate
    if not isinstance(lr, torch.Tensor):
        lr = float(np.float32(lr))
    target = num / torch.clamp_min(den, 1e-12)
    return torch.where(den > 1e-8, w + lr * (target - w), w)


# -- the CUDA kernel ----------------------------------------------------------

TILE = 64  # the edge of a GEMM block's output tile in csrc/kohonen.cu (its TILE)
KC = 64  # the features of one reduction chunk there (its KC)
MAX_GRID_Y = 65535  # a CUDA grid's y extent: the launches' tiles of B or M
# blocks that fill the card: two resident GEMM blocks on each of an H100's 132 SMs
TARGET_BLOCKS = 2 * 132


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def split_count(b: int, m: int, f: int) -> int:
    """Pieces the scores launch splits F into: 1 when its ``[B tile, M tile]``
    blocks fill the card, else enough pieces of whole 64-feature chunks to
    come near :data:`TARGET_BLOCKS` (every piece non-empty)."""
    nch, blocks = _ceil_div(f, KC), _ceil_div(b, TILE) * _ceil_div(m, TILE)
    want = min(nch, max(1, _ceil_div(TARGET_BLOCKS, blocks)))
    return _ceil_div(nch, _ceil_div(nch, want))


def buffer_shapes(b: int, m: int, f: int) -> Dict[str, Tuple[int, ...]]:
    """Every buffer of one kernel call, by name, in 4-byte elements: the
    neighbourhood table, each piece's partial scores and ``|w|^2`` and the
    winners (int32, taken when the caller passes no ``winners_out``), all
    scratch that the kernel writes whole before it reads it, then the
    results ``num`` and ``den``."""
    nsplit = split_count(b, m, f)
    return {"neigh": (m, m), "scores": (nsplit, b, m), "sq": (nsplit, m), "win": (b,),
            "num": (m, f), "den": (m, 1)}


_split_count = functools.lru_cache(maxsize=64)(split_count)


@functools.lru_cache(maxsize=64)
def _layout(b: int, m: int, f: int) -> Tuple[Dict[str, int], int]:
    """Each buffer's offset in elements when :func:`buffer_shapes` is laid out
    in order in one block, and the block's size; once per shape."""
    offsets, total = {}, 0
    for name, shape in buffer_shapes(b, m, f).items():
        offsets[name] = total
        total += math.prod(shape)
    return offsets, total


def _buffers(b: int, m: int, f: int, device):
    """``(num [M, F], den [M, 1], {name: data pointer})`` of the buffers of
    :func:`buffer_shapes`, uninitialised, carved from one float32 allocation
    (the table first, so that it starts on 16 bytes).  Pointers and not
    views: at the model's shape a call's host time is most of its time, and
    ``num`` and ``den`` keep the allocation alive."""
    offsets, total = _layout(b, m, f)
    block = torch.empty(total, dtype=torch.float32, device=device)
    base = block.data_ptr()
    num = block.as_strided((m, f), (f, 1), offsets["num"])
    den = block.as_strided((m, 1), (1, 1), offsets["den"])
    return num, den, {name: base + 4 * off for name, off in offsets.items()}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("kohonen")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.znicz_kohonen_accumulate.argtypes = [ptr] * 10 + [i32] * 4 + [ptr, ptr]
    lib.znicz_kohonen_accumulate.restype = i32
    lib.znicz_kohonen_error_string.argtypes = [i32]
    lib.znicz_kohonen_error_string.restype = ctypes.c_char_p
    return lib


def _check(w, x, mask, d2m, tss) -> None:
    """Raise ``ValueError`` on what the kernel does not take."""
    card = x.get_device()  # -1 off the card
    if (card >= 0 and w.get_device() == card and mask.get_device() == card
            and d2m.get_device() == card and tss.get_device() == card
            and tss.numel() == 1 and tss.dtype == torch.float32
            and x.dtype == w.dtype == mask.dtype == d2m.dtype == torch.float32
            and x.is_contiguous() and w.is_contiguous() and mask.is_contiguous()
            and d2m.is_contiguous() and x.dim() == 2 and w.dim() == 2
            and x.shape[1] == w.shape[1] and mask.shape == x.shape[:1]
            and d2m.shape == (w.shape[0], w.shape[0])
            and _ceil_div(max(x.shape[0], w.shape[0]), TILE) <= MAX_GRID_Y):
        return  # the common case, in few host operations; what fails, by name below
    for name, t in (("w", w), ("x", x), ("mask", mask), ("d2m", d2m), ("tss", tss)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"kohonen accumulate: kernel needs CUDA tensors on one card, "
                             f"got {name} on {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"kohonen accumulate: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"kohonen accumulate: {name} must be contiguous")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"kohonen accumulate: want x [B, F] and w [M, F], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    m = w.shape[0]
    if tss.numel() != 1:
        raise ValueError(f"kohonen accumulate: tss must hold one value, got {tuple(tss.shape)}")
    if mask.shape != (x.shape[0],) or d2m.shape != (m, m):
        raise ValueError(f"kohonen accumulate: want mask [B] and d2m [M, M], got "
                         f"{tuple(mask.shape)} and {tuple(d2m.shape)}")
    if _ceil_div(max(x.shape[0], m), TILE) > MAX_GRID_Y:
        raise ValueError(f"kohonen accumulate: B {x.shape[0]} and M {m} must be at most "
                         f"{MAX_GRID_Y * TILE} (their {TILE}-row tiles are a grid's y axis, "
                         f"at most {MAX_GRID_Y})")


def accumulate(w, x, mask, d2m, tss, *, winners_out: Optional[torch.Tensor] = None):
    """``(num [M, F], den [M, 1])`` of one batch-SOM step: the plain version
    for CPU tensors, else the kernel (counted in ``accumulate.launches``).
    ``tss``: ``2 sigma^2`` as a one-value float32 tensor on x's device
    (:func:`sigma_tensor`), which the kernel reads through its pointer.
    ``winners_out`` (CUDA int32 ``[B]``), if given, receives the kernel's
    winners."""
    if w.is_cpu and x.is_cpu and mask.is_cpu and d2m.is_cpu:
        return accumulate_reference(w, x, mask, d2m, tss)
    _check(w, x, mask, d2m, tss)
    b, f = x.shape
    m = w.shape[0]
    if b == 0:
        return (torch.zeros((m, f), dtype=torch.float32, device=x.device),
                torch.zeros((m, 1), dtype=torch.float32, device=x.device))
    num, den, ptr = _buffers(b, m, f, x.device)
    if winners_out is None:
        win = ptr["win"]
    elif (winners_out.dtype != torch.int32 or winners_out.shape != (b,)
          or winners_out.device != x.device or not winners_out.is_contiguous()):
        raise ValueError("kohonen accumulate: winners_out must be a contiguous int32 [B] "
                         "tensor on x's card")
    else:
        win = winners_out.data_ptr()
    args = (x.data_ptr(), w.data_ptr(), mask.data_ptr(), d2m.data_ptr(), ptr["scores"],
            ptr["sq"], ptr["neigh"], win, ptr["num"], ptr["den"], b, m, f,
            _split_count(b, m, f), tss.data_ptr())
    # the current stream's handle, as torch.cuda.current_stream(card).cuda_stream
    # gives it, without building a Stream object a call
    card = x.get_device()
    if card == torch.cuda.current_device():
        rc = _lib().znicz_kohonen_accumulate(*args, torch._C._cuda_getCurrentRawStream(card))
    else:
        with torch.cuda.device(card):
            rc = _lib().znicz_kohonen_accumulate(*args, torch._C._cuda_getCurrentRawStream(card))
    if rc != 0:
        msg = _lib().znicz_kohonen_error_string(rc).decode()
        raise RuntimeError(f"kohonen accumulate: kernel launch failed with CUDA error {rc} ({msg})")
    accumulate.launches += 1
    return num, den


accumulate.launches = 0


def train_step(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,
    coords: torch.Tensor,
    *,
    learning_rate,
    tss: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    mesh=None,
    data_axis: str = "data",
    d2m: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Fused twin of ``ops/kohonen.py::train_step`` (returns only the new
    params; winners are cheap to recompute with ``ops.kohonen.winners``).
    ``learning_rate``: a host scalar or a 0-d float32 tensor; ``tss``: ``2
    sigma^2`` as :func:`accumulate` takes it.
    ``d2m``: the map's :func:`pairwise_d2`, computed here when not given.
    ``mesh``: ``x`` and ``mask`` are this rank's shard of a batch split
    over the mesh's ``data_axis``; the rank's ``(num, den)`` are summed
    over the axis (one all-reduce, the JAX package's psum rule) before the
    update, so every rank applies the full batch's update."""
    w = params["weights"]
    if mask is None:
        mask = torch.ones((x.shape[0],), dtype=x.dtype, device=x.device)
    if d2m is None:
        d2m = pairwise_d2(coords)
    num, den = accumulate(w, x, mask, d2m, tss)
    if mesh is not None:
        from znicz_tpu_torch.parallel.data_parallel import psum

        num, den = psum([num, den], mesh, data_axis)
    return {"weights": _apply_update(w, num, den, learning_rate)}

