"""Fused cross-channel LRN for Hopper: a Triton forward and a CUDA C++ backward.

Replaces the TPU kernels of ``znicz_tpu/ops/pallas/lrn.py``: ``lrn`` (the
``pl.pallas_call`` over ``_fwd_kernel``, :123) and ``_lrn_bwd`` (the one over
``_bwd_kernel``, :138-152, kernel at :80).  Math, all in f32 with casts at
load and store::

    s_c  = k + alpha * sum_{c' = c - n//2}^{c + n - 1 - n//2} x_{c'}^2
    y_c  = x_c * s_c^-beta
    dx_c = g_c * s_c^-beta
           - 2 alpha beta x_c * sum_{c' = c - (n - 1 - n//2)}^{c + n//2} g_{c'} x_{c'} s_{c'}^(-beta-1)

The backward window has the forward's extents swapped (its adjoint), which
matters for even ``n``.

Bound on an H100: device-memory bytes.  The forward reads x and writes y;
the backward reads x and g and writes dx; there is no tensor-core work.  At
AlexNet's norm1 (``[128, 55, 55, 96]`` bf16, 74.3 MB a tensor) that is
148.7 MB forward and 223 MB backward, 44 us and 67 us at 3.35 TB/s.

Forward (Triton): the input is viewed as ``[rows, C]`` (rows = N*H*W, C
contiguous).  One program owns a ``[BLOCK_R, next_pow2(C)]`` row tile with
the whole channel axis, so every window lies inside the tile and nothing
crosses programs.  Each input is loaded once, with aligned vector loads, and
the window sums shift the tile in registers (``tl.gather`` along the
channel axis).  The TPU kernel's ``[C, C]`` band matmul (a way onto the
TPU's matrix unit, ``2C`` flops an element where the window needs ``n``) is
dropped.  Tiles: 2048 elements a program, 4 warps.

Backward (CUDA C++, ``znicz_tpu_torch/csrc/lrn.cu``, plain C interface,
built with ``nvcc`` for ``sm_90a`` at first use by :mod:`cuda_build`, loaded
with ctypes, launched on PyTorch's current stream): each thread owns a
vector of consecutive channels of one row, 16 bytes (8 bf16 or 4 f32) where
C and the pointers allow it, so no lane is padding at C 96 or 256; a block
walks a few tiles of whole rows, loads x and g once in 16-byte accesses
(the next tile's while it computes this one), keeps them in registers, and
trades only the windows' halos (two channels each side at n <= 5) with its
row neighbours through shared memory.  The other shapes (n > 5, odd C,
misaligned views, rows past 1024 vectors) take the source's general
kernel, whose rows sit whole in shared memory: C up to :data:`MAX_C`.
:func:`launch_geometry` picks the kernel, the vector, the rows a tile and
the grid.  s is recomputed from x, never read from a residual the forward
wrote, which would add a tensor's bytes each way.  ``s^-beta`` uses
rsqrt/sqrt chains for beta in {0.25, 0.5, 0.75, 1} and exp/log otherwise,
in all the kernels and in the plain versions; the backward takes the
special-function unit's approximations for them and for its division
(a few ulp, within the f32 check's 1e-5).

The wrappers take a CPU tensor to the plain PyTorch versions below
(:func:`lrn_reference`, :func:`lrn_bwd_reference`) and launch the kernel for
a CUDA tensor, or raise; they count launches in ``lrn_forward.launches`` and
``lrn_backward.launches``.  Triton is imported, and the forward compiled,
and the backward built, at the first launch, never at module import.  Both
launch on the current stream and read no device value on the host, so a
step that ran once eagerly (that first launch) can be captured into a CUDA
graph; a replay launches what the capture recorded, without passing
through the wrappers or their counts.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from znicz_tpu_torch.ops.kernels import cuda_build

DTYPES = (torch.float32, torch.bfloat16)
# elements of one forward program's tile: BLOCK_R * BLOCK_C
_FWD_TILE = 2048


# -- plain PyTorch versions (CPU path and the kernels' oracle) -------------

def _inv_pow(s: torch.Tensor, beta: float) -> torch.Tensor:
    """s**-beta via rsqrt/sqrt chains for the common betas, exp/log
    otherwise (the same chains as the JAX package's ``_inv_pow``)."""
    if beta == 0.75:
        t = torch.rsqrt(s)
        return t * torch.sqrt(t)
    if beta == 0.5:
        return torch.rsqrt(s)
    if beta == 0.25:
        return torch.sqrt(torch.rsqrt(s))
    if beta == 1.0:
        return 1.0 / s
    return torch.exp(-beta * torch.log(s))


def _window_sum(v: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """out_c = sum_{c' = c - lo}^{c + hi} v_{c'} over the last axis, zero
    outside; summed shift by shift in the kernels' order."""
    c = v.shape[-1]
    vp = F.pad(v, (lo, hi))
    out = torch.zeros_like(v)
    for d in range(lo + hi + 1):
        out = out + vp[..., d : d + c]
    return out


def lrn_reference(
    x: torch.Tensor, alpha: float, beta: float, k: float, n: int
) -> torch.Tensor:
    """Plain LRN forward over the last axis; f32 math, result in x.dtype."""
    xf = x.float()
    s = k + alpha * _window_sum(xf * xf, n // 2, n - 1 - n // 2)
    return (xf * _inv_pow(s, beta)).to(x.dtype)


def lrn_bwd_reference(
    x: torch.Tensor,
    g: torch.Tensor,
    alpha: float,
    beta: float,
    k: float,
    n: int,
) -> torch.Tensor:
    """Plain LRN input gradient for output gradient ``g``."""
    lo, hi = n // 2, n - 1 - n // 2
    xf, gf = x.float(), g.float()
    s = k + alpha * _window_sum(xf * xf, lo, hi)
    s_negb = _inv_pow(s, beta)
    inner = gf * xf * s_negb / s
    wsum = _window_sum(inner, hi, lo)  # adjoint: extents swapped
    return (gf * s_negb - 2.0 * alpha * beta * xf * wsum).to(x.dtype)


# -- the Triton kernels ----------------------------------------------------

@functools.cache
def _kernels():
    """Import triton and define the kernels (compiled per constexpr set at
    their first launch).  The names are bound as module globals because
    Triton resolves a kernel's names through the function's globals."""
    global triton, tl, _tl_inv_pow, _tl_window_sum
    import triton
    import triton.language as tl

    @triton.jit
    def _tl_inv_pow(s, BETA: tl.constexpr):
        if BETA == 0.75:
            t = tl.rsqrt(s)
            r = t * tl.sqrt(t)
        elif BETA == 0.5:
            r = tl.rsqrt(s)
        elif BETA == 0.25:
            r = tl.sqrt(tl.rsqrt(s))
        elif BETA == 1.0:
            r = 1.0 / s
        else:
            r = tl.exp(-BETA * tl.log(s))
        return r

    @triton.jit
    def _tl_window_sum(v, c, C, LO: tl.constexpr, N: tl.constexpr):
        """out_c = sum_{c' = c - LO}^{c - LO + N - 1} v_{c'} along axis 1 of
        a register tile, zero outside [0, C): shifts by in-register gathers."""
        acc = tl.zeros(v.shape, tl.float32)
        for d in tl.static_range(N):
            cd = c + (d - LO)
            idx = tl.broadcast_to(
                tl.minimum(tl.maximum(cd, 0), v.shape[1] - 1), v.shape
            )
            acc += tl.where((cd >= 0) & (cd < C), tl.gather(v, idx, axis=1), 0.0)
        return acc

    @triton.jit
    def lrn_fwd_kernel(
        x_ptr, y_ptr, rows, C, alpha, k,
        N: tl.constexpr, LO: tl.constexpr, BETA: tl.constexpr,
        BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr,
    ):
        r = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)[:, None]
        c = tl.arange(0, BLOCK_C)[None, :]
        ok = (r < rows) & (c < C)
        off = r.to(tl.int64) * C + c
        x = tl.load(x_ptr + off, mask=ok, other=0.0).to(tl.float32)
        s = k + alpha * _tl_window_sum(x * x, c, C, LO, N)
        y = x * _tl_inv_pow(s, BETA)
        tl.store(y_ptr + off, y.to(y_ptr.dtype.element_ty), mask=ok)

    return triton, lrn_fwd_kernel


def _blocks(c: int, tile: int):
    block_c = 1 << max(c - 1, 0).bit_length()
    return max(1, tile // block_c), block_c


def _check(name: str, *tensors: torch.Tensor) -> None:
    x = tensors[0]
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: kernel needs CUDA tensors, got {t.device}")
        if t.dtype not in DTYPES:
            raise ValueError(f"{name}: dtype {t.dtype} not in {DTYPES}")
        if t.dtype != x.dtype or t.shape != x.shape or t.device != x.device:
            raise ValueError(f"{name}: inputs differ in dtype, shape or card")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the [rows, C] view needs a contiguous tensor")
    if x.dim() < 1 or x.shape[-1] == 0:
        raise ValueError(f"{name}: needs a non-empty channel axis")


# -- wrappers: plain version on the CPU, the kernel on the card ------------

def lrn_forward(x: torch.Tensor, alpha: float, beta: float, k: float, n: int) -> torch.Tensor:
    """LRN forward: the plain version for a CPU tensor, else the kernel
    (counted in ``lrn_forward.launches``); raises on what it does not take."""
    if x.device.type == "cpu":
        return lrn_reference(x, alpha, beta, k, n)
    _check("lrn forward", x)
    triton, fwd = _kernels()
    c = x.shape[-1]
    rows = x.numel() // c
    y = torch.empty_like(x)
    if rows == 0:
        return y
    block_r, block_c = _blocks(c, _FWD_TILE)
    fwd[(triton.cdiv(rows, block_r),)](
        x, y, rows, c, float(alpha), float(k),
        N=int(n), LO=int(n) // 2, BETA=float(beta),
        BLOCK_R=block_r, BLOCK_C=block_c, num_warps=4,
    )
    lrn_forward.launches += 1
    return y


# -- the CUDA backward: its launch geometry ---------------------------------

# the halo kernel's windows reach two channels each side (n <= 5) and its
# threads one vector each, at most a block's 1024; the rows kernel holds two
# f32 rows of C in a block's 227 KB (232,448 bytes) of shared memory
HALO_MAX_N = 5
HALO_TILES = 4  # tiles of rows a halo block walks (csrc/lrn.cu's HALO_TILES)
MAX_THREADS = 1024
ROWS_THREADS = 256
MAX_C = 232448 // 8
ROWS_TILE = 4096  # f32 values of x^2 (and as many inner terms) a rows block stages
_BETA_KIND = {0.75: 0, 0.5: 1, 0.25: 2, 1.0: 3}  # else 4: exp/log


class Geometry(NamedTuple):
    halo: bool  # the halo kernel (the main path), else the rows kernel
    vec: int  # channels a thread accesses at once: 16 bytes where C and the pointers allow
    rows_per_block: int  # a tile: a halo block walks HALO_TILES of them, a rows block one
    threads: int
    grid: int


def _halo_rows(vpr: int) -> int:
    """Rows a halo block owns, at ``vpr`` vectors a row: few padding lanes
    in its last warp first, then near 256 threads."""
    def cost(r):
        t = -(-r * vpr // 32) * 32
        return (t - r * vpr) / t + 0.1 * abs(math.log2(t / 256))
    return min(range(1, MAX_THREADS // vpr + 1), key=cost)


@functools.lru_cache(maxsize=256)
def _block_geometry(c: int, esize: int, align: int, n: int):
    vec = 16 // esize
    while vec > 1 and (c % vec or align % (vec * esize)):
        vec //= 2
    vpr = c // vec
    if n <= HALO_MAX_N and vec >= 2 and vpr <= MAX_THREADS:
        r = _halo_rows(vpr)
        return True, vec, r, -(-r * vpr // 32) * 32
    return False, vec, max(1, ROWS_TILE // c), ROWS_THREADS


def launch_geometry(rows: int, c: int, esize: int, align: int, n: int) -> Geometry:
    """The backward's launch for ``rows`` rows of ``c`` channels of
    ``esize``-byte elements whose pointers are all aligned to ``align``
    bytes (a power of two) and window ``n``: the kernel, the vector (the
    largest of 16, 8, 4 or 2 bytes, or one element, that divides C and the
    alignment), the rows a block, its threads and the grid.  C at most
    :data:`MAX_C`."""
    halo, vec, r, threads = _block_geometry(c, esize, min(align, 16), n)
    tiles = -(-rows // r)
    return Geometry(halo, vec, r, threads, -(-tiles // HALO_TILES) if halo else tiles)


def _alignment(*tensors: torch.Tensor) -> int:
    """The largest power of two, up to 16, that divides every data pointer."""
    bits = 0
    for t in tensors:
        bits |= t.data_ptr()
    return min(16, bits & -bits) if bits else 16


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("lrn")
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.znicz_lrn_bwd.argtypes = [ptr, ptr, ptr, i64, i32, i32, f32, f32, i32, f32, f32,
                                  i32, i32, i32, i32, i32, ptr]
    lib.znicz_lrn_bwd.restype = i32
    lib.znicz_lrn_error_string.argtypes = [i32]
    lib.znicz_lrn_error_string.restype = ctypes.c_char_p
    return lib


def _launch_bwd(x, g, dx, alpha: float, beta: float, k: float, n: int) -> None:
    """One launch of the CUDA backward into ``dx`` (uncounted: the checks
    call it too); x, g and dx already checked, non-empty."""
    c = x.shape[-1]
    if c > MAX_C:
        raise ValueError(f"lrn backward: C {c} is above the kernel's limit {MAX_C} (two f32 "
                         f"rows of C in a block's 227 KB of shared memory)")
    rows = x.numel() // c
    geo = launch_geometry(rows, c, x.element_size(), _alignment(x, g, dx), n)
    args = (x.data_ptr(), g.data_ptr(), dx.data_ptr(), rows, c, int(n), float(alpha), float(k),
            _BETA_KIND.get(float(beta), 4), -float(beta), 2.0 * alpha * beta,
            int(x.dtype == torch.bfloat16), int(geo.halo), geo.vec, geo.rows_per_block,
            geo.threads)
    # the current stream's handle, as torch.cuda.current_stream(card).cuda_stream
    # gives it, without building a Stream object a call
    card = x.get_device()
    if card == torch.cuda.current_device():
        rc = _lib().znicz_lrn_bwd(*args, torch._C._cuda_getCurrentRawStream(card))
    else:
        with torch.cuda.device(card):
            rc = _lib().znicz_lrn_bwd(*args, torch._C._cuda_getCurrentRawStream(card))
    if rc != 0:
        msg = _lib().znicz_lrn_error_string(rc).decode()
        raise RuntimeError(f"lrn backward: kernel launch failed with CUDA error {rc} ({msg})")


def lrn_backward(
    x: torch.Tensor, g: torch.Tensor, alpha: float, beta: float, k: float, n: int
) -> torch.Tensor:
    """LRN input gradient: the plain version for CPU tensors, else the
    CUDA kernel (counted in ``lrn_backward.launches``); raises on what it
    does not take."""
    if x.device.type == "cpu":
        return lrn_bwd_reference(x, g, alpha, beta, k, n)
    _check("lrn backward", x, g)
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx
    _launch_bwd(x, g, dx, alpha, beta, k, n)
    lrn_backward.launches += 1
    return dx


lrn_forward.launches = 0
lrn_backward.launches = 0


class _LRN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alpha, beta, k, n):
        ctx.save_for_backward(x)
        ctx.hyper = (alpha, beta, k, n)
        return lrn_forward(x, alpha, beta, k, n)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return lrn_backward(x, g.contiguous(), *ctx.hyper), None, None, None, None


def lrn(
    x: torch.Tensor,
    alpha: float = 1e-4,
    beta: float = 0.75,
    k: float = 2.0,
    n: int = 5,
) -> torch.Tensor:
    """Differentiable fused LRN over the last axis of a contiguous tensor."""
    return _LRN.apply(x, float(alpha), float(beta), float(k), int(n))
