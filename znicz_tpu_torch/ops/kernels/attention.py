"""Flash attention for Hopper: forward, dQ and dK/dV kernels in CUDA C++.

Replaces the three TPU kernels of ``znicz_tpu/ops/pallas/attention.py``:

- ``flash_fwd``: ``_flash_fwd_impl`` (the ``pl.pallas_call`` over
  ``_fwd_kernel``, :212): online-softmax attention, ``out`` and the
  per-row logsumexp ``lse``;
- ``flash_dq``: ``_flash_bwd``'s call over ``_dq_kernel`` (:265):
  ``dq = scale * sum_k ds.K`` with ``ds = p (dp - delta)``;
- ``flash_dkv``: ``_flash_bwd``'s call over ``_dkv_kernel`` (:277):
  ``dv = sum_q p^T.dout``, ``dk = scale * sum_q ds^T.q``.

The kernels are in ``znicz_tpu_torch/csrc/flash_attention.cu`` (plain C
interface, built with ``nvcc`` for ``sm_90a`` at first use by
:mod:`cuda_build`, loaded with ctypes).  What bounds them on an H100:
operations.  At the LM slice (``B*H = 128``, ``T = 2048``, ``D = 64``,
causal, so ``T(T+1)/2`` live (q, k) pairs a head) the forward does 2
products of ``2 D`` flops a pair (~69 GFLOP), dQ 3 and dK/dV 4, against
~0.13 GB of q, k, v and out: far above the card's ops-per-byte line.  In
each kernel a block owns one 64-row tile and loops over the other side's
64-row tiles (the TPU grid's sequential axis becomes that loop).

- The bf16 forward, dQ and dK/dV run on the tensor cores (``mma.sync``
  m16n8k16, bf16 operands, f32 accumulation: the TPU kernels' contract).
  Four warps own 16 rows each; ``p`` and ``ds`` go from the score products'
  f32 accumulators, rounded to bf16 where the TPU kernels cast them,
  straight into the next product's operand, never through shared memory;
  the forward's online softmax (row max, rescale, row sum of the unrounded
  ``p``) runs on those accumulators, ``p`` as ``exp2`` of one FMA; one bf16
  copy of each tile sits in shared memory, read by ``ldmatrix`` in both
  orientations; the next tile's ``cp.async`` copies are in flight while
  this one is computed.  These copies need q, k, v and dout to start on a
  16-byte boundary, which the wrappers check for every kernel.
- The f32 forward, dQ and dK/dV run on the tensor cores in 3xTF32
  (``mma.sync`` m16n8k8 tf32, f32 accumulation), on the bf16 kernels'
  skeleton: each f32 operand is split into a big and a small TF32 part,
  ``b = tf32(x)`` and ``s = x - b`` (the tensor cores read its top 19
  bits, so ``x = b + s`` to 2^-21 of ``x``), and a product is taken as
  ``a_s.c_b + a_b.c_s + a_b.c_b``.  The dropped ``a_s.c_s`` is at most
  2^-22 of the product, so each product keeps about f32's accuracy (a few
  f32 roundings) where plain TF32 would keep 2^-11; ``p``, ``ds`` and every
  sum stay f32 (no long sum is left in an mma accumulator, which
  truncates), and the split is the only approximation.  The forward keeps
  the bf16 forward's online softmax, with ``p`` from ``exp2f`` in f32.  On
  the card their errors against float64 stay within a few times the f32
  plain version's (``chip_smoke.py`` fails past 10 times).  ``p`` and
  ``ds`` enter the next product from the accumulators with the k axis
  permuted (m16n8k8's A fragment does not match its accumulator), never
  through shared memory.  ``wgmma`` with TMA for all six comes later.

Tiles are the kernels' own: ``block_q``/``block_k`` are accepted so JAX
call sites load unchanged, and are ignored (the TPU's 512 x 512 blocks were
a VMEM choice).

:func:`flash_attention_lse` takes what JAX's kernel takes up to head dim
128: its autograd layer makes the inputs contiguous and 16-byte aligned,
and zero-pads a head dim between the kernels' 16, 32, 64 and 128 up to the
next (exact: zero columns change no score, and give zero output and
gradient columns), with the scale of the true head dim.  Above 128 it
raises ``NotImplementedError`` on the card (``attention="auto"`` takes the
dense path there).  The counted wrappers launch a B*H above the grid's 65535
a batch slice at a time.

The layout stays BTHD ``[B, T, H, D]`` (``lse``: ``[B, T, H]``); the
kernels read it through strides, so the JAX package's ``[B*H, T, D]``
transposes and its zero-padding of T are gone: the ragged tile is masked by
index.  Beside each kernel is its plain PyTorch version
(:func:`flash_fwd_reference`, :func:`flash_dq_reference`,
:func:`flash_dkv_reference`), which the
wrappers take for CPU tensors; for CUDA tensors they launch the kernel or
raise, and count launches in ``flash_fwd.launches``, ``flash_dq.launches``
and ``flash_dkv.launches``.  The library is built at the first launch;
the wrappers launch on the current stream and read no device value on the
host, so a step that ran once eagerly can be captured into a CUDA graph,
whose replays launch the kernels without passing through the wrappers or
their counts.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from znicz_tpu_torch.ops.kernels import cuda_build

BLOCK_Q = 512  # the JAX package's defaults, accepted and ignored
BLOCK_K = 512
NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
MAX_GRID_Y = 65535  # (batch, head) pairs of one launch
DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the C interface's dtype codes


# -- plain PyTorch versions (CPU path and the kernels' oracle) -------------

def _mask(t: int, causal: bool, device) -> torch.Tensor:
    """[q, k] validity; equal-length self-attention has no padded rows."""
    if not causal:
        return torch.ones((t, t), dtype=torch.bool, device=device)
    return torch.ones((t, t), dtype=torch.bool, device=device).tril()


def flash_fwd_reference(q, k, v, *, causal: bool, scale: float):
    """Dense masked attention with the kernels' numerics: f32 scores, a
    stable softmax, ``p`` cast to ``v.dtype`` before ``p.V``, ``l`` floored
    at 1e-30.  Returns ``(out [B,T,H,D] in q.dtype, lse [B,T,H] f32)``."""
    ok = _mask(q.shape[1], causal, q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = torch.where(ok, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    out = acc / l.permute(0, 2, 1, 3)
    lse = (m + torch.log(l))[..., 0].permute(0, 2, 1)
    return out.to(q.dtype), lse.contiguous()


def _p_ds(q, k, v, dout, lse, delta, causal, scale):
    """Recomputed probabilities (masked entries exactly 0) and
    ``ds = p (dp - delta)``, both [B, H, Tq, Tk] f32.  ``delta`` is
    ``rowsum(dout * out) - dlse`` ([B, T, H], f32)."""
    ok = _mask(q.shape[1], causal, q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.where(ok, torch.exp(s - lse.permute(0, 2, 1)[..., None]), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float())
    return p, p * (dp - delta.permute(0, 2, 1)[..., None])


def flash_dq_reference(q, k, v, dout, lse, delta, *, causal: bool, scale: float):
    """dQ from the forward's residuals, ``ds`` cast to k's dtype before
    ``ds.K`` as the TPU kernel casts it."""
    _, ds = _p_ds(q, k, v, dout, lse, delta, causal, scale)
    dq = scale * torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float())
    return dq.to(q.dtype)


def flash_dkv_reference(q, k, v, dout, lse, delta, *, causal: bool, scale: float):
    """``(dk, dv)`` from the forward's residuals, ``ds^T`` cast to q's dtype
    before ``ds^T.q`` and ``p^T`` to dout's before ``p^T.dout``."""
    p, ds = _p_ds(q, k, v, dout, lse, delta, causal, scale)
    dk = scale * torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dout.dtype).float(), dout.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# -- the CUDA kernels ---------------------------------------------------------

@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("flash_attention")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.znicz_flash_fwd.argtypes = [ptr] * 5 + [i32] * 6 + [f32, ptr]
    lib.znicz_flash_dq.argtypes = [ptr] * 7 + [i32] * 6 + [f32, ptr]
    lib.znicz_flash_dkv.argtypes = [ptr] * 8 + [i32] * 6 + [f32, ptr]
    for fn in (lib.znicz_flash_fwd, lib.znicz_flash_dq, lib.znicz_flash_dkv):
        fn.restype = i32
    lib.znicz_flash_smem_bytes.argtypes = [i32, i32, i32]
    lib.znicz_flash_smem_bytes.restype = i32
    lib.znicz_cuda_error_string.argtypes = [i32]
    lib.znicz_cuda_error_string.restype = ctypes.c_char_p
    return lib


def smem_bytes(kernel: str, d: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory a block of ``kernel`` ("fwd", "dq" or "dkv")
    asks for at head dim ``d`` and ``dtype``, as the C launcher computes it."""
    return _lib().znicz_flash_smem_bytes(("fwd", "dq", "dkv").index(kernel), d, DTYPES[dtype])


def _check(name: str, qkv, stats=()) -> None:
    """Raise ``ValueError`` on what the kernels do not take."""
    x = qkv[0]
    for t in (*qkv, *stats):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name}: kernel needs CUDA tensors on one card, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: kernel reads contiguous [B, T, H, D] tensors")
    if x.dim() != 4:
        raise ValueError(f"{name}: want [B, T, H, D] tensors, got shape {tuple(x.shape)}")
    for t in qkv:
        if t.dtype not in DTYPES:
            raise ValueError(f"{name}: dtype {t.dtype} not in {tuple(DTYPES)}")
        if t.dtype != x.dtype or t.shape != x.shape:
            raise ValueError(f"{name}: q, k, v (and dout) differ in dtype or shape")
        if t.data_ptr() % 16:
            raise ValueError(
                f"{name}: kernel copies 16-byte pieces; a tensor's data starts at "
                f"{t.data_ptr() % 16} bytes past a 16-byte boundary (a view at an offset)"
            )
    _, _, h, d = x.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {HEAD_DIMS}")
    if h > MAX_GRID_Y:
        raise ValueError(f"{name}: {h} heads exceed the grid's {MAX_GRID_Y} blocks of one batch row")
    for t in stats:
        if t.dtype != torch.float32 or t.shape != x.shape[:3]:
            raise ValueError(f"{name}: lse and delta must be float32 [B, T, H]")


def _batch_slices(x: torch.Tensor):
    """The batch ranges of one launch each: the grid holds at most 65535
    (batch, head) pairs, so a larger B*H is launched a batch slice at a
    time (a contiguous, 16-byte-aligned view of every tensor)."""
    b, _, h, _ = x.shape
    step = MAX_GRID_Y // h
    return [slice(b0, min(b0 + step, b)) for b0 in range(0, b, step)]


def _launch(name: str, fn, x: torch.Tensor, tensors, causal: bool, scale: float) -> None:
    b, t, h, d = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(
            *(ctypes.c_void_p(a.data_ptr()) for a in tensors),
            b, t, h, d, DTYPES[x.dtype], int(causal), float(scale), ctypes.c_void_p(stream),
        )
    if rc != 0:
        msg = _lib().znicz_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc} ({msg})")


# -- wrappers: plain version on the CPU, the kernel on the card ------------

def flash_fwd(q, k, v, *, causal: bool, scale: float):
    """``(out, lse)``: the plain version for CPU tensors, else the forward
    kernel (counted in ``flash_fwd.launches``, one a launch: B*H above
    65535 takes more than one); raises on what it does not take."""
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, causal=causal, scale=scale)
    _check("flash_fwd", (q, k, v))
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return out, lse
    for sl in _batch_slices(q):
        _launch("flash_fwd", _lib().znicz_flash_fwd, q[sl],
                (q[sl], k[sl], v[sl], out[sl], lse[sl]), causal, scale)
        flash_fwd.launches += 1
    return out, lse


def flash_dq(q, k, v, dout, lse, delta, *, causal: bool, scale: float):
    """dQ: the plain version for CPU tensors, else the dQ kernel (counted
    in ``flash_dq.launches``)."""
    if q.device.type == "cpu":
        return flash_dq_reference(q, k, v, dout, lse, delta, causal=causal, scale=scale)
    _check("flash_dq", (q, k, v, dout), (lse, delta))
    dq = torch.empty_like(q)
    if q.numel() == 0:
        return dq
    for sl in _batch_slices(q):
        _launch("flash_dq", _lib().znicz_flash_dq, q[sl],
                (q[sl], k[sl], v[sl], dout[sl], lse[sl], delta[sl], dq[sl]), causal, scale)
        flash_dq.launches += 1
    return dq


def flash_dkv(q, k, v, dout, lse, delta, *, causal: bool, scale: float):
    """``(dk, dv)``: the plain version for CPU tensors, else the dK/dV
    kernel (counted in ``flash_dkv.launches``)."""
    if q.device.type == "cpu":
        return flash_dkv_reference(q, k, v, dout, lse, delta, causal=causal, scale=scale)
    _check("flash_dkv", (q, k, v, dout), (lse, delta))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dk, dv
    for sl in _batch_slices(q):
        _launch("flash_dkv", _lib().znicz_flash_dkv, q[sl],
                (q[sl], k[sl], v[sl], dout[sl], lse[sl], delta[sl], dk[sl], dv[sl]),
                causal, scale)
        flash_dkv.launches += 1
    return dk, dv


flash_fwd.launches = 0
flash_dq.launches = 0
flash_dkv.launches = 0


def kernel_head_dim(d: int) -> Optional[int]:
    """The head dim the kernels run a head dim ``d`` at: the next of
    :data:`HEAD_DIMS`, the columns past ``d`` zero; None above 128."""
    return next((k for k in HEAD_DIMS if k >= d), None)


def _ready(x: torch.Tensor, d: int) -> torch.Tensor:
    """x contiguous, 16-byte aligned and zero-padded along the head dim to
    ``d`` (zero columns change no score and give zero output and gradient
    columns, so the padding is exact)."""
    x = x.contiguous()
    if x.shape[-1] != d:
        x = torch.nn.functional.pad(x, (0, d - x.shape[-1]))
    elif x.data_ptr() % 16:
        x = x.clone()
    return x


class _Flash(torch.autograd.Function):
    """``(out, lse)`` with both outputs differentiable: an lse cotangent
    folds into ``delta = rowsum(dout * out) - dlse`` (plain PyTorch, as it
    was XLA outside the TPU kernels), so the backward kernels need no new
    input.  Here, not in the counted wrappers, inputs are made contiguous
    and aligned, and a head dim between the kernels' is zero-padded up to
    the next one (:func:`kernel_head_dim`) and sliced back after."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        d = q.shape[-1]
        dp = kernel_head_dim(d) or d
        q, k, v = (_ready(x, dp) for x in (q, k, v))
        out, lse = flash_fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.hyper = (causal, scale, d)
        return out[..., :d].contiguous() if dp != d else out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        causal, scale, d = ctx.hyper
        dout = _ready(dout, q.shape[-1])
        delta = ((dout.float() * out.float()).sum(dim=-1) - dlse.float()).contiguous()
        dq = flash_dq(q, k, v, dout, lse, delta, causal=causal, scale=scale)
        dk, dv = flash_dkv(q, k, v, dout, lse, delta, causal=causal, scale=scale)
        if q.shape[-1] != d:
            dq, dk, dv = (g[..., :d].contiguous() for g in (dq, dk, dv))
        return dq, dk, dv, None, None


def flash_attention_lse(
    q: torch.Tensor,  # [B, T, H, D]
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale=None,
    block_q: int = BLOCK_Q,
    block_k: int = BLOCK_K,
):
    """Flash attention returning ``(out [B,T,H,D], lse [B,T,H] f32)``, both
    differentiable (ring attention merges shards through the lse).
    ``block_q``/``block_k`` are accepted and ignored: the CUDA kernels use
    their own 64-row tiles."""
    del block_q, block_k
    if q.device.type == "cuda" and kernel_head_dim(q.shape[-1]) is None:
        raise NotImplementedError(
            f"flash attention at head dim {q.shape[-1]} (above 128) has no kernel yet "
            f"(ROADMAP.md B6, a D-256 instantiation); use attention='dot'"
        )
    if scale is None:  # the true head dim's, before any padding
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _Flash.apply(q, k, v, bool(causal), float(scale))


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale=None,
    block_q: int = BLOCK_Q,
    block_k: int = BLOCK_K,
) -> torch.Tensor:
    """Drop-in twin of :func:`znicz_tpu_torch.ops.attention.dot_product_attention`
    (BTHD layout)."""
    out, _ = flash_attention_lse(
        q, k, v, causal=causal, scale=scale, block_q=block_q, block_k=block_k
    )
    return out
