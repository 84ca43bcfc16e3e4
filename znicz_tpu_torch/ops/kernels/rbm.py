"""Fused RBM CD-k statistics for Hopper, in CUDA C++.

Replaces the TPU kernel of ``znicz_tpu/ops/pallas/rbm.py``: ``_statistics``
(the ``pl.pallas_call`` over ``_cd_kernel``, :161), which runs a whole CD-k
Gibbs chain and emits the masked statistics ``dW``, ``dvb``, ``dhb`` and
``(err_sum, mask_sum)``; the ``lr / n_valid`` update runs outside.

The kernel is ``znicz_tpu_torch/csrc/rbm.cu`` (plain C interface, built
with ``nvcc`` for ``sm_90a`` at first use by :mod:`cuda_build`, loaded with
ctypes): one tiled GEMM on the tensor cores in 3xTF32 (``mma.sync``
m16n8k8), launched ``2k + 2`` times a step with a sampling epilogue for
each product of the chain and a last launch for the statistics.  The
chain's states live between launches in buffers that this wrapper
allocates (:func:`_buffers`), so any shape that fits the card runs; sums
run in a fixed order (no atomics, the same bits every run).  One C call
is one logical step: ``statistics.launches`` counts one per call that
reaches the card.  The kernel reads its seed through a pointer to a uint32
on the card, so a step captured into a CUDA graph replays with each step's
own seed.  What bounds it and why it is built so: see the source.

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
interpret mode is (``ops/pallas/rbm.py:148-157``), or led along a given
sample path (``samples=``: the kernel's own, to hold it to float64 and
count its flips); :func:`statistics` takes it for CPU tensors, with the
twin's uniforms from :func:`chain_uniforms`, and for CUDA tensors
launches the kernel or raises.
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

def statistics_reference(params, v0, mask, uh, uv, *, cd_k: int, chain: Optional[dict] = None,
                         samples=None):
    """``(dW [V, H], dvb [V], dhb [H], stats [2])`` of a CD-k chain driven by
    the uniforms ``uh [1+k, B, H]`` and ``uv [k, B, V]``, as ``_cd_kernel``
    computes them; ``stats`` is ``(sum_b mean_v (v0 - vp)^2 m_b, sum_b
    m_b)``.  ``samples=(hidden [k, B, H], visible [k, B, V])``, if given,
    are taken as the chain's draws instead of thresholding the uniforms
    (which may then be None): the first hidden draw and each step's
    visible and hidden ones, the last step's hidden units never being
    drawn.  ``chain``, if given, receives ``h0p``, ``vp``, ``hp``, the
    draws (``hidden_samples``, ``visible_samples``) and the probability
    each was drawn from (``hidden_probs``, ``visible_probs``)."""
    w, vb, hb = params["weights"], params["vbias"], params["hbias"]

    def draw(p, k, side):  # side 0: hidden, 1: visible
        if samples is not None:
            return samples[side][k].to(v0.dtype)
        return ((uh, uv)[side][k] < p).to(v0.dtype)

    h0p = hp = torch.sigmoid(v0 @ w + hb)
    hs, vs, hps, vps = [], [], [], []
    for k in range(cd_k):
        h = draw(hp, k, 0)
        vp = torch.sigmoid(h @ w.T + vb)
        v = draw(vp, k, 1)
        hs.append(h), hps.append(hp), vs.append(v), vps.append(vp)
        hp = torch.sigmoid(v @ w + hb)
    if chain is not None:
        chain.update(h0p=h0p, vp=vp, hp=hp, hidden_samples=torch.stack(hs),
                     visible_samples=torch.stack(vs), hidden_probs=torch.stack(hps),
                     visible_probs=torch.stack(vps))
    m = mask[:, None]
    dw = (v0 * m).T @ h0p - (vp * m).T @ hp
    dvb = torch.sum((v0 - vp) * m, dim=0)
    dhb = torch.sum((h0p - hp) * m, dim=0)
    err = torch.sum(torch.mean(torch.square(v0 - vp), dim=1) * mask)
    return dw, dvb, dhb, torch.stack([err, torch.sum(mask)])


def count_flips(chain, led, uh, uv) -> int:
    """Draws of ``chain`` (a kernel's) that the plain version, led along the
    same samples (``led``: its ``chain`` from ``statistics_reference(...,
    samples=)``), would have drawn the other way from the same uniforms:
    every draw of the chain is counted."""
    cd_k = uv.shape[0]
    return int(((uh[:cd_k] < led["hidden_probs"]).to(torch.float32)
                != chain["hidden_samples"]).sum()
               + ((uv < led["visible_probs"]).to(torch.float32)
                  != chain["visible_samples"]).sum())


def _apply_update(params, dw, dvb, dhb, stats, learning_rate):
    """``param + (lr / n_valid) * statistic`` and the mean error
    (``ops/pallas/rbm.py:198-206``); ``n_valid = max(sum mask, 1)`` stays on
    the device, and so may ``learning_rate`` (a 0-d float32 tensor; a host
    scalar is taken in float32).  ``lr / n_valid`` is ``lr * (1 /
    n_valid)``, as Python's ``float / tensor`` computes it."""
    n_valid = torch.clamp_min(stats[1], 1.0)
    if not isinstance(learning_rate, torch.Tensor):
        learning_rate = float(np.float32(learning_rate))
    lr = torch.reciprocal(n_valid) * learning_rate
    new = {
        "weights": params["weights"] + lr * dw,
        "vbias": params["vbias"] + lr * dvb,
        "hbias": params["hbias"] + lr * dhb,
    }
    return new, stats[0] / n_valid


# -- the CUDA kernel ----------------------------------------------------------

TILE = 64  # the edge of a GEMM block's output tile in csrc/rbm.cu (its TILE)
MAX_GRID_Y = 65535  # a CUDA grid's y extent: the launches' row tiles of B or V


def _tiles(n: int) -> int:
    return -(-n // TILE)


def buffer_shapes(b: int, v: int, h: int, cd_k: int) -> Dict[str, Tuple[int, ...]]:
    """Every output and scratch buffer of one kernel call, by name, in the C
    entry's order: the chain's probabilities and draws, the partial sums of
    the error (one a row and 64-column tile), of ``dvb`` and ``dhb`` (one a
    64-row tile and column), and the four statistics."""
    return {
        "h0p": (b, h), "vp": (b, v), "hp": (b, h),
        "hidden_samples": (cd_k, b, h), "visible_samples": (cd_k, b, v),
        "err_part": (b, _tiles(v)), "dvb_part": (_tiles(b), v), "dhb_part": (_tiles(b), h),
        "dw": (v, h), "dvb": (v,), "dhb": (h,), "stats": (2,),
    }


def _buffers(b: int, v: int, h: int, cd_k: int, device) -> Dict[str, torch.Tensor]:
    """The buffers of :func:`buffer_shapes`, uninitialised: the kernel writes
    each whole before it reads it."""
    return {name: torch.empty(shape, dtype=torch.float32, device=device)
            for name, shape in buffer_shapes(b, v, h, cd_k).items()}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("rbm")
    ptr, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    lib.znicz_rbm_cd.argtypes = [ptr] * 19 + [i32] * 4 + [ptr, ptr]
    lib.znicz_rbm_cd.restype = i32
    lib.znicz_rbm_uniforms.argtypes = [ptr, ctypes.c_longlong, u32, u32, ptr]
    lib.znicz_rbm_uniforms.restype = i32
    lib.znicz_rbm_error_string.argtypes = [i32]
    lib.znicz_rbm_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().znicz_rbm_error_string(rc).decode()
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error {rc} ({msg})")


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


def seed_tensor(seed: int, device) -> torch.Tensor:
    """A chain seed as the kernel reads it: the low 32 bits of a host int in
    a one-value int32 tensor on ``device``."""
    bits = np.array([int(seed) & M32], np.uint32).view(np.int32)
    return torch.tensor(bits, device=device)


def _check(params, v0, mask, cd_k, uniforms, seed) -> None:
    """Raise ``ValueError`` on what the kernel does not take."""
    w = params["weights"]
    if (seed.device != v0.device or seed.numel() != 1
            or seed.dtype not in (torch.int32, torch.uint32)):
        raise ValueError(f"rbm statistics: the seed must be one int32 on v0's card, got "
                         f"{seed.dtype} {tuple(seed.shape)} on {seed.device}")
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
    if b == 0:
        raise ValueError("rbm statistics: empty batch")
    if _tiles(max(b, v)) > MAX_GRID_Y:
        raise ValueError(f"rbm statistics: B {b} and V {v} must be at most "
                         f"{MAX_GRID_Y * TILE} (their {TILE}-row tiles are a grid's y axis, "
                         f"at most {MAX_GRID_Y})")


def statistics(params, v0, mask, seed, *, cd_k: int, uniforms=None,
               chain: Optional[dict] = None):
    """``(dW, dvb, dhb, stats)`` of one CD-k chain: the plain version for
    CPU tensors (with :func:`chain_uniforms` of ``seed`` unless
    ``uniforms=(uh, uv)`` is given), else the kernel, which draws from
    ``seed`` itself or reads ``uniforms`` (counted in
    ``statistics.launches``).  ``seed``: a one-value int32 tensor (its
    bits the uint32 seed, :func:`seed_tensor`) on v0's device, which the
    kernel reads through its pointer.  ``chain``, if given, receives the chain's
    ``h0p``, ``vp``, ``hp`` and its draws, ``hidden_samples [k, B, H]`` (the
    first hidden draw, then each step's but the last) and
    ``visible_samples [k, B, V]``; the plain version adds the probabilities
    they were drawn from (see :func:`statistics_reference`)."""
    b, v = v0.shape
    h = params["hbias"].shape[0]
    tensors = [v0, mask, *params.values(), *(uniforms or ())]
    if all(t.device.type == "cpu" for t in tensors):
        uh, uv = uniforms if uniforms is not None else chain_uniforms(
            int(seed.reshape(-1)[0]) & M32, b, v, h, cd_k, v0.device)
        return statistics_reference(params, v0, mask, uh, uv, cd_k=cd_k, chain=chain)
    _check(params, v0, mask, cd_k, uniforms, seed)
    out = _buffers(b, v, h, cd_k, v0.device)
    uh, uv = uniforms if uniforms is not None else (None, None)
    ptrs = [v0, mask, params["weights"], params["vbias"], params["hbias"], uh, uv,
            *out.values()]
    with torch.cuda.device(v0.device):
        s = torch.cuda.current_stream(v0.device).cuda_stream
        rc = _lib().znicz_rbm_cd(
            *(ctypes.c_void_p(None if t is None else t.data_ptr()) for t in ptrs),
            b, v, h, cd_k, ctypes.c_void_p(seed.data_ptr()), ctypes.c_void_p(s),
        )
    _raise_on(rc, "rbm statistics")
    statistics.launches += 1
    if chain is not None:
        chain.update({k: out[k] for k in ("h0p", "vp", "hp", "hidden_samples",
                                          "visible_samples")})
    return out["dw"], out["dvb"], out["dhb"], out["stats"]


statistics.launches = 0


def cd_step(
    params: Dict[str, torch.Tensor],
    v0: torch.Tensor,
    seed,
    *,
    learning_rate,
    cd_k: int = 1,
    mask: Optional[torch.Tensor] = None,
    mesh=None,
    data_axis: str = "data",
):
    """Fused twin of ``ops/rbm.py::cd_step``; returns (new params, mean
    reconstruction error).  ``seed`` (the train state's step, a one-value
    int32 tensor, as :func:`statistics` takes it) keys the
    chain's draws; ``learning_rate`` is a host scalar or a 0-d float32
    tensor.  ``mesh``: ``v0`` and ``mask`` are this rank's shard of a batch
    split over the mesh's ``data_axis`` (the JAX package's psum rule): the
    rank's chain draws from ``seed * n_shards + rank`` (``seed + rank``
    would make step s's shard d replay step s+1's shard d-1 when the
    caller passes seed = step), and ``(dW, dvb, dhb, stats)`` are summed
    over the axis (one all-reduce) before the update, which every rank
    then applies alike."""
    if mask is None:
        mask = torch.ones((v0.shape[0],), dtype=v0.dtype, device=v0.device)
    if mesh is not None:
        from znicz_tpu_torch.parallel.data_parallel import data_index, psum
        from znicz_tpu_torch.parallel.mesh import axis_size

        seed = seed * axis_size(mesh, data_axis) + data_index(mesh)
    dw, dvb, dhb, stats = statistics(params, v0, mask, seed, cd_k=cd_k)
    if mesh is not None:
        dw, dvb, dhb, stats = psum([dw, dvb, dhb, stats], mesh, data_axis)
    return _apply_update(params, dw, dvb, dhb, stats, learning_rate)
