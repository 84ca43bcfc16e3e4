"""Fused Kohonen batch-SOM statistics for Hopper, in CUDA C++.

Replaces the TPU kernel of ``znicz_tpu/ops/pallas/kohonen.py``:
``_accumulate`` (the ``pl.pallas_call`` over ``_accum_kernel``, :93), which
fuses the winner search, the neighbourhood weights and the two
accumulations ``num = h^T x`` and ``den = sum_b h`` of one batch-SOM step.

The kernel is ``znicz_tpu_torch/csrc/kohonen.cu`` (plain C interface, built
with ``nvcc`` for ``sm_90a`` at first use by :mod:`cuda_build`, loaded with
ctypes): one launch finds the winners, a second one owns each ``[units x
features]`` tile of ``num`` and loops over the batch in a fixed order, so
the result is the same bits from run to run (no atomics).  What bounds it
and why it is built so: see the source.  The two launches are one logical
step: ``accumulate.launches`` counts one per call that reaches the card.

Beside it is the plain PyTorch version, :func:`accumulate_reference`, the
CPU path and the kernel's oracle; :func:`accumulate` takes it for CPU
tensors and, for CUDA tensors, launches the kernel or raises.
:func:`train_step` is the fused twin of ``ops/kohonen.py::train_step``, as
``ops/pallas/kohonen.py::train_step`` is in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import numpy as np
import torch

from znicz_tpu_torch.ops.kernels import cuda_build
from znicz_tpu_torch.ops.kohonen import two_sigma_sq


def pairwise_d2(coords: torch.Tensor) -> torch.Tensor:
    """``[M, M]`` squared grid distances between the map's units (fixed for
    a map: compute it once and pass it along)."""
    return torch.sum(torch.square(coords[:, None, :] - coords[None, :, :]), dim=-1)


# -- the plain PyTorch version (CPU path and the kernel's oracle) ---------------

def accumulate_reference(w, x, mask, d2m, sigma, *, win=None):
    """``(num [M, F], den [M, 1])`` as ``_accum_kernel`` computes them:
    winners ``argmax(x.w^T - |w|^2 / 2)`` (or ``win``, given), then
    ``h = exp(-d2m[win] / (2 sigma^2)) * mask`` and its two sums."""
    if win is None:
        scores = x @ w.T - 0.5 * torch.sum(w * w, dim=1)[None, :]
        win = torch.argmax(scores, dim=1)
    neigh = torch.exp(-d2m / two_sigma_sq(sigma))  # [M, M]
    h = neigh[win.long()] * mask[:, None]  # [B, M]
    return h.T @ x, torch.sum(h, dim=0)[:, None]


def _apply_update(w, num, den, learning_rate):
    """``w + lr (num / den - w)`` where ``den > 1e-8``, else ``w``
    (``ops/pallas/kohonen.py:119-122``); ``learning_rate`` is a host scalar,
    taken in float32."""
    lr = float(np.float32(learning_rate))
    target = num / torch.clamp_min(den, 1e-12)
    return torch.where(den > 1e-8, w + lr * (target - w), w)


# -- the CUDA kernel ----------------------------------------------------------

@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("kohonen")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.znicz_kohonen_accumulate.argtypes = [ptr] * 7 + [i32] * 3 + [f32, ptr]
    lib.znicz_kohonen_accumulate.restype = i32
    lib.znicz_kohonen_error_string.argtypes = [i32]
    lib.znicz_kohonen_error_string.restype = ctypes.c_char_p
    return lib


def _check(w, x, mask, d2m) -> None:
    """Raise ``ValueError`` on what the kernel does not take."""
    for name, t in (("w", w), ("x", x), ("mask", mask), ("d2m", d2m)):
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
    if mask.shape != (x.shape[0],) or d2m.shape != (m, m):
        raise ValueError(f"kohonen accumulate: want mask [B] and d2m [M, M], got "
                         f"{tuple(mask.shape)} and {tuple(d2m.shape)}")


def accumulate(w, x, mask, d2m, sigma, *, winners_out: Optional[torch.Tensor] = None):
    """``(num [M, F], den [M, 1])`` of one batch-SOM step: the plain version
    for CPU tensors, else the kernel (counted in ``accumulate.launches``).
    ``sigma`` is a host scalar.  ``winners_out`` (CUDA int32 ``[B]``), if
    given, receives the kernel's winners."""
    if all(t.device.type == "cpu" for t in (w, x, mask, d2m)):
        return accumulate_reference(w, x, mask, d2m, sigma)
    _check(w, x, mask, d2m)
    b, f = x.shape
    m = w.shape[0]
    num = torch.empty((m, f), dtype=torch.float32, device=x.device)
    den = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    if b == 0:
        return num.zero_(), den.zero_()
    if winners_out is None:
        winners_out = torch.empty((b,), dtype=torch.int32, device=x.device)
    elif (winners_out.dtype != torch.int32 or winners_out.shape != (b,)
          or winners_out.device != x.device or not winners_out.is_contiguous()):
        raise ValueError("kohonen accumulate: winners_out must be a contiguous int32 [B] "
                         "tensor on x's card")
    ptrs = (x, w, mask, d2m, winners_out, num, den)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _lib().znicz_kohonen_accumulate(
            *(ctypes.c_void_p(t.data_ptr()) for t in ptrs),
            b, m, f, two_sigma_sq(sigma), ctypes.c_void_p(stream),
        )
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
    sigma,
    mask: Optional[torch.Tensor] = None,
    mesh=None,
    data_axis: str = "data",
    d2m: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Fused twin of ``ops/kohonen.py::train_step`` (returns only the new
    params; winners are cheap to recompute with ``ops.kohonen.winners``).
    ``d2m``: the map's :func:`pairwise_d2`, computed here when not given.
    ``mesh`` (the JAX package's sharded-batch rule) is not ported."""
    del data_axis
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (the sharded-batch Kohonen step) is not ported to znicz_tpu_torch "
            "yet (ROADMAP.md A6, parallel/)"
        )
    w = params["weights"]
    if mask is None:
        mask = torch.ones((x.shape[0],), dtype=x.dtype, device=x.device)
    if d2m is None:
        d2m = pairwise_d2(coords)
    num, den = accumulate(w, x, mask, d2m, sigma)
    return {"weights": _apply_update(w, num, den, learning_rate)}

