"""Fused RBM CD-k statistics for Hopper, in CUDA C++.

Replaces the TPU kernel of ``znicz_tpu/ops/pallas/rbm.py``: ``_statistics``
(the ``pl.pallas_call`` over ``_cd_kernel``, :161), which runs a whole CD-k
Gibbs chain and emits the masked statistics ``dW``, ``dvb``, ``dhb`` and
``(err_sum, mask_sum)``; the ``lr / n_valid`` update runs outside.

The kernel is ``znicz_tpu_torch/csrc/rbm.cu`` (plain C interface, built
with ``nvcc`` for ``sm_90a`` at first use by :mod:`cuda_build`, loaded with
ctypes): one launch runs the chain for a few batch rows a block with their
states in shared memory, a second one owns each tile of ``dW`` and sums
over the batch in a fixed order (no atomics, the same bits every run).  The
two launches are one logical step: ``statistics.launches`` counts one per
call that reaches the card.  What bounds it and why it is built so: see the
source.

Random numbers: the TPU kernel samples with the TPU's hardware PRNG, which
nothing reproduces.  Here each uniform is Philox4x32-10 at key ``(seed,
stream)`` and counter ``(n, 0, 0, 0)``, ``n`` the element's flat index in
``uh [1 + k, B, H]`` (stream 0) or ``uv [k, B, V]`` (stream 1), taken as the
first word's 24 low bits times 2^-24.  :func:`philox_uniforms` is a
bit-identical PyTorch twin of the kernel's generator (int64 arithmetic
with 16-bit limbs, as torch has no general uint32 arithmetic), so the card
and the CPU path draw the same numbers from the same seed.

Beside the kernel is its plain PyTorch version,
:func:`statistics_reference`, fed explicit uniforms as the JAX kernel's
interpret mode is (``ops/pallas/rbm.py:148-157``); :func:`statistics` takes
it for CPU tensors, with the twin's uniforms from :func:`chain_uniforms`,
and for CUDA tensors launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from znicz_tpu_torch.ops.kernels import cuda_build

M32 = 0xFFFFFFFF
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
HIDDEN, VISIBLE = 0, 1  # the two streams of a chain's draws


# -- the counter-based generator, in PyTorch ------------------------------------

def _mulhilo(a: int, b: torch.Tensor):
    """``(hi, lo)`` 32-bit halves of ``a * b`` for a uint32 constant ``a`` and
    uint32 values ``b`` held in int64: ``b`` split into 16-bit limbs so that
    no partial product leaves int64."""
    x = a * (b >> 16)  # < 2^48
    z = ((x & 0xFFFF) << 16) + a * (b & 0xFFFF)  # < 2^49
    return (x >> 16) + (z >> 32), z & M32


def philox4x32_10(counter, key: Tuple[int, int]):
    """Philox4x32-10 of four int64 tensors of uint32 counter words under the
    key ``(k0, k1)``; returns the four output words, int64."""
    c0, c1, c2, c3 = counter
    k0, k1 = key[0] & M32, key[1] & M32
    for _ in range(10):
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + PHILOX_W0) & M32, (k1 + PHILOX_W1) & M32
    return c0, c1, c2, c3


def philox_uniforms(seed: int, stream: int, shape, device="cpu") -> torch.Tensor:
    """float32 uniforms in [0, 1) on the 2^-24 grid: element ``n`` (flat
    index in ``shape``) is the kernel's draw at key ``(seed, stream)``,
    counter ``(n, 0, 0, 0)``."""
    numel = int(np.prod(shape))
    n = torch.arange(numel, dtype=torch.int64, device=device)
    zero = torch.zeros_like(n)
    word = philox4x32_10((n & M32, n >> 32, zero, zero), (seed, stream))[0]
    return ((word & 0xFFFFFF).to(torch.float32) * (1.0 / (1 << 24))).reshape(shape)


def chain_uniforms(seed: int, b: int, v: int, h: int, cd_k: int, device="cpu"):
    """``(uh [1 + k, B, H], uv [k, B, V])``: the uniforms a CD-k chain of
    ``seed`` draws, as the kernel draws them."""
    return (
        philox_uniforms(seed, HIDDEN, (1 + cd_k, b, h), device),
        philox_uniforms(seed, VISIBLE, (cd_k, b, v), device),
    )


# -- the plain PyTorch version (CPU path and the kernel's oracle) ---------------

def statistics_reference(params, v0, mask, uh, uv, *, cd_k: int, chain: Optional[dict] = None):
    """``(dW [V, H], dvb [V], dhb [H], stats [2])`` of a CD-k chain driven by
    the uniforms ``uh [1+k, B, H]`` and ``uv [k, B, V]``, as ``_cd_kernel``
    computes them; ``stats`` is ``(sum_b mean_v (v0 - vp)^2 m_b, sum_b
    m_b)``.  ``chain``, if given, receives ``h0p``, ``vp`` and ``hp``."""
    w, vb, hb = params["weights"], params["vbias"], params["hbias"]
    h0p = torch.sigmoid(v0 @ w + hb)
    h = (uh[0] < h0p).to(v0.dtype)
    for k in range(cd_k):
        vp = torch.sigmoid(h @ w.T + vb)
        v = (uv[k] < vp).to(v0.dtype)
        hp = torch.sigmoid(v @ w + hb)
        h = (uh[k + 1] < hp).to(v0.dtype)
    if chain is not None:
        chain.update(h0p=h0p, vp=vp, hp=hp)
    m = mask[:, None]
    dw = (v0 * m).T @ h0p - (vp * m).T @ hp
    dvb = torch.sum((v0 - vp) * m, dim=0)
    dhb = torch.sum((h0p - hp) * m, dim=0)
    err = torch.sum(torch.mean(torch.square(v0 - vp), dim=1) * mask)
    return dw, dvb, dhb, torch.stack([err, torch.sum(mask)])


def _apply_update(params, dw, dvb, dhb, stats, learning_rate):
    """``param + (lr / n_valid) * statistic`` and the mean error
    (``ops/pallas/rbm.py:198-206``); ``n_valid = max(sum mask, 1)`` stays on
    the device."""
    n_valid = torch.clamp_min(stats[1], 1.0)
    lr = float(np.float32(learning_rate)) / n_valid
    new = {
        "weights": params["weights"] + lr * dw,
        "vbias": params["vbias"] + lr * dvb,
        "hbias": params["hbias"] + lr * dhb,
    }
    return new, stats[0] / n_valid


# -- the CUDA kernel ----------------------------------------------------------

@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("rbm")
    ptr, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    lib.znicz_rbm_cd.argtypes = [ptr] * 15 + [i32] * 4 + [u32, ptr]
    lib.znicz_rbm_cd.restype = i32
    lib.znicz_rbm_uniforms.argtypes = [ptr, ctypes.c_longlong, u32, u32, ptr]
    lib.znicz_rbm_uniforms.restype = i32
    lib.znicz_rbm_chain_rows.argtypes = [i32] * 3
    lib.znicz_rbm_chain_rows.restype = i32
    lib.znicz_rbm_chain_smem_bytes.argtypes = [i32] * 3
    lib.znicz_rbm_chain_smem_bytes.restype = ctypes.c_longlong
    lib.znicz_rbm_error_string.argtypes = [i32]
    lib.znicz_rbm_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().znicz_rbm_error_string(rc).decode()
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error {rc} ({msg})")


def chain_rows(b: int, v: int, h: int, device="cuda") -> Tuple[int, int]:
    """(batch rows a chain block takes, its dynamic shared memory in bytes)
    for this shape on ``device``; rows 0 means the shape does not fit."""
    with torch.cuda.device(device):
        rows = _lib().znicz_rbm_chain_rows(b, v, h)
    return rows, (_lib().znicz_rbm_chain_smem_bytes(rows, v, h) if rows else 0)


def uniforms_cuda(seed: int, stream: int, shape, device="cuda") -> torch.Tensor:
    """The kernel's own uniforms of ``(seed, stream)`` over ``shape``, drawn
    on the card (to hold the generator against :func:`philox_uniforms`)."""
    out = torch.empty(shape, dtype=torch.float32, device=device)
    with torch.cuda.device(out.device):
        s = torch.cuda.current_stream(out.device).cuda_stream
        rc = _lib().znicz_rbm_uniforms(ctypes.c_void_p(out.data_ptr()), out.numel(),
                                       seed & M32, stream, ctypes.c_void_p(s))
    _raise_on(rc, "rbm uniforms")
    return out


def _check(params, v0, mask, cd_k, uniforms) -> None:
    """Raise ``ValueError`` on what the kernel does not take."""
    w = params["weights"]
    named = [("v0", v0), ("mask", mask), ("weights", w), ("vbias", params["vbias"]),
             ("hbias", params["hbias"])]
    if uniforms is not None:
        named += [("uh", uniforms[0]), ("uv", uniforms[1])]
    for name, t in named:
        if t.device.type != "cuda" or t.device != v0.device:
            raise ValueError(f"rbm statistics: kernel needs CUDA tensors on one card, "
                             f"got {name} on {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"rbm statistics: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"rbm statistics: {name} must be contiguous")
    if cd_k < 1:
        raise ValueError(f"rbm statistics: cd_k must be >= 1, got {cd_k}")
    b, v = v0.shape
    h = w.shape[1]
    want = {"mask": (b,), "weights": (v, h), "vbias": (v,), "hbias": (h,),
            "uh": (1 + cd_k, b, h), "uv": (cd_k, b, v)}
    for name, t in named[1:]:
        if tuple(t.shape) != want[name]:
            raise ValueError(f"rbm statistics: {name} has shape {tuple(t.shape)}, "
                             f"want {want[name]}")


def statistics(params, v0, mask, seed: int, *, cd_k: int, uniforms=None,
               chain: Optional[dict] = None):
    """``(dW, dvb, dhb, stats)`` of one CD-k chain: the plain version for
    CPU tensors (with :func:`chain_uniforms` of ``seed`` unless
    ``uniforms=(uh, uv)`` is given), else the kernel, which draws from
    ``seed`` itself or reads ``uniforms`` (counted in
    ``statistics.launches``).  ``chain``, if given, receives the chain's
    ``h0p``, ``vp`` and ``hp``."""
    b, v = v0.shape
    h = params["hbias"].shape[0]
    tensors = [v0, mask, *params.values(), *(uniforms or ())]
    if all(t.device.type == "cpu" for t in tensors):
        uh, uv = uniforms if uniforms is not None else chain_uniforms(
            seed, b, v, h, cd_k, v0.device)
        return statistics_reference(params, v0, mask, uh, uv, cd_k=cd_k, chain=chain)
    _check(params, v0, mask, cd_k, uniforms)
    if b == 0:
        raise ValueError("rbm statistics: empty batch")
    dev = v0.device
    f32 = dict(dtype=torch.float32, device=dev)
    dw = torch.empty((v, h), **f32)
    dvb, dhb, stats = torch.empty((v,), **f32), torch.empty((h,), **f32), torch.empty((2,), **f32)
    h0p, vp, hp = torch.empty((b, h), **f32), torch.empty((b, v), **f32), torch.empty((b, h), **f32)
    err_row = torch.empty((b,), **f32)
    if chain_rows(b, v, h, dev)[0] == 0:
        raise ValueError(f"rbm statistics: V + H = {v + h} does not fit a block's shared "
                         "memory (the limit is about 14,000 units)")
    uh, uv = uniforms if uniforms is not None else (None, None)
    ptrs = [v0, mask, params["weights"], params["vbias"], params["hbias"], uh, uv,
            h0p, vp, hp, err_row, dw, dvb, dhb, stats]
    with torch.cuda.device(dev):
        s = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().znicz_rbm_cd(
            *(ctypes.c_void_p(None if t is None else t.data_ptr()) for t in ptrs),
            b, v, h, cd_k, int(seed) & M32, ctypes.c_void_p(s),
        )
    _raise_on(rc, "rbm statistics")
    statistics.launches += 1
    if chain is not None:
        chain.update(h0p=h0p, vp=vp, hp=hp)
    return dw, dvb, dhb, stats


statistics.launches = 0


def cd_step(
    params: Dict[str, torch.Tensor],
    v0: torch.Tensor,
    seed: int,
    *,
    learning_rate,
    cd_k: int = 1,
    mask: Optional[torch.Tensor] = None,
    mesh=None,
    data_axis: str = "data",
):
    """Fused twin of ``ops/rbm.py::cd_step``; returns (new params, mean
    reconstruction error).  ``seed`` is a host int (the train state's step)
    that keys the chain's draws.  ``mesh`` (the JAX package's sharded-batch
    rule) is not ported."""
    del data_axis
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (the sharded-batch CD-k step) is not ported to znicz_tpu_torch "
            "yet (ROADMAP.md A6, parallel/)"
        )
    if mask is None:
        mask = torch.ones((v0.shape[0],), dtype=v0.dtype, device=v0.device)
    dw, dvb, dhb, stats = statistics(params, v0, mask, seed, cd_k=cd_k)
    return _apply_update(params, dw, dvb, dhb, stats, learning_rate)
