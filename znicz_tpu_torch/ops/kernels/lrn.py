"""Fused cross-channel LRN for Hopper: a Triton forward/backward kernel pair.

Replaces the TPU kernels of ``znicz_tpu/ops/pallas/lrn.py``: ``lrn`` (the
``pl.pallas_call`` over ``_fwd_kernel``) and ``_lrn_bwd`` (the one over
``_bwd_kernel``).  Math, all in f32 with casts at load and store::

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

Design: the input is viewed as ``[rows, C]`` (rows = N*H*W, C contiguous).
One program owns a ``[BLOCK_R, next_pow2(C)]`` row tile with the whole
channel axis, so every window lies inside the tile and nothing crosses
programs.  Each input is loaded once, with aligned vector loads, and the
window sums shift the tile in registers (``tl.gather`` along the channel
axis), so device memory sees one read of each input and one write of the
output.  The TPU kernel's ``[C, C]`` band matmul (a way onto the TPU's
matrix unit, ``2C`` flops an element where the window needs ``n``) is
dropped.  The backward recomputes ``s`` from x instead of reading an ``s``
residual written by the forward, which would add a tensor's bytes each way.
``s^-beta`` uses rsqrt/sqrt chains for beta in {0.25, 0.5, 0.75, 1} and
exp/log otherwise.  Tiles (elements a program): 2048 forward, 1024 backward,
4 warps each.

The wrappers take a CPU tensor to the plain PyTorch versions below
(:func:`lrn_reference`, :func:`lrn_bwd_reference`) and launch the kernel for
a CUDA tensor; they count launches in ``lrn_forward.launches`` and
``lrn_backward.launches``.  Triton is imported, and the kernels compiled,
at the first launch, never at module import.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

DTYPES = (torch.float32, torch.bfloat16)
# elements of one program's tile: BLOCK_R * BLOCK_C
_FWD_TILE = 2048
_BWD_TILE = 1024


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

    @triton.jit
    def lrn_bwd_kernel(
        x_ptr, g_ptr, dx_ptr, rows, C, alpha, k, two_ab,
        N: tl.constexpr, LO: tl.constexpr, HI: tl.constexpr,
        BETA: tl.constexpr, BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr,
    ):
        r = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)[:, None]
        c = tl.arange(0, BLOCK_C)[None, :]
        ok = (r < rows) & (c < C)
        off = r.to(tl.int64) * C + c
        x = tl.load(x_ptr + off, mask=ok, other=0.0).to(tl.float32)
        g = tl.load(g_ptr + off, mask=ok, other=0.0).to(tl.float32)
        s = k + alpha * _tl_window_sum(x * x, c, C, LO, N)
        s_negb = _tl_inv_pow(s, BETA)
        inner = tl.where(ok, g * x * s_negb / s, 0.0)  # g x s^(-beta-1)
        wsum = _tl_window_sum(inner, c, C, HI, N)  # adjoint: extents swapped
        dx = g * s_negb - two_ab * x * wsum
        tl.store(dx_ptr + off, dx.to(dx_ptr.dtype.element_ty), mask=ok)

    return triton, lrn_fwd_kernel, lrn_bwd_kernel


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
        if t.dtype != x.dtype or t.shape != x.shape:
            raise ValueError(f"{name}: inputs differ in dtype or shape")
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
    triton, fwd, _ = _kernels()
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


def lrn_backward(
    x: torch.Tensor, g: torch.Tensor, alpha: float, beta: float, k: float, n: int
) -> torch.Tensor:
    """LRN input gradient: the plain version for CPU tensors, else the
    kernel (counted in ``lrn_backward.launches``)."""
    if x.device.type == "cpu":
        return lrn_bwd_reference(x, g, alpha, beta, k, n)
    _check("lrn backward", x, g)
    triton, _, bwd = _kernels()
    c = x.shape[-1]
    rows = x.numel() // c
    dx = torch.empty_like(x)
    if rows == 0:
        return dx
    block_r, block_c = _blocks(c, _BWD_TILE)
    bwd[(triton.cdiv(rows, block_r),)](
        x, g, dx, rows, c, float(alpha), float(k), 2.0 * alpha * beta,
        N=int(n), LO=int(n) // 2, HI=int(n) - 1 - int(n) // 2, BETA=float(beta),
        BLOCK_R=block_r, BLOCK_C=block_c, num_warps=4,
    )
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
