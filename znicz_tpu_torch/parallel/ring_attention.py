"""Ring attention: sequence parallelism over a mesh axis (port of
``znicz_tpu/parallel/ring_attention.py``).

The sequence axis is split over the ranks of one mesh axis; each rank's Q
block stays put while the K/V blocks travel the ring, one hop a step
(:func:`~znicz_tpu_torch.parallel.tensor_parallel.ppermute`, K and V in
one exchange), so attention over ``n * T_local`` positions holds
``O(T_local^2)`` scores a rank.  The blocks merge by the online softmax:
the dense inner by its running max and normalizer, the flash inner
through each block's lse.

One process runs one device, so where the JAX package's ``shard_map``
body sees the rank's block, here the caller passes it: ``q``, ``k`` and
``v`` are this rank's sequence block ``[B, T/n, H, D]``.  The causal
branch (a past block whole, the diagonal causal, a future block skipped)
is a host integer a step, so it is Python control flow; every rank still
exchanges on every step, and the exchanges ride one
:class:`~znicz_tpu_torch.parallel.tensor_parallel.Chain`, so the backward
runs them in the same order on every rank whichever blocks it skipped.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from znicz_tpu_torch.ops.kernels.attention import flash_attention_lse
from znicz_tpu_torch.parallel.data_parallel import axis_group
from znicz_tpu_torch.parallel.tensor_parallel import Chain, group_rank, group_size, ppermute

SEQ_AXIS = "data"  # default: the ring over the data axis of parallel.make_mesh


def _ring_step(o, m, l, q, k_blk, v_blk, *, scale, causal, my, src, t_local):
    """One dense block merged into the running ``(o, m, l)`` ([B, H, Tq,
    D], [B, H, Tq], [B, H, Tq], float32)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_blk.float()) * scale
    if causal:
        q_pos = my * t_local + torch.arange(t_local, device=q.device)
        k_pos = src * t_local + torch.arange(t_local, device=q.device)
        mask = q_pos[:, None] >= k_pos[None, :]
        s = torch.where(mask, s, -math.inf)
    m_new = torch.maximum(m, s.amax(dim=-1))
    # a fully masked row keeps -inf: its exponentials are taken against 0
    m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(torch.isneginf(s), 0.0, p)
    correction = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_safe))
    l_new = l * correction + p.sum(dim=-1)
    o_new = o * correction[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v_blk.float())
    return o_new, m_new, l_new


def _local_ring(q, k, v, *, group, chain, causal, scale):
    """This rank's block [B, T_local, H, D] through the dense ring (plain
    PyTorch: f32 scores, running max and normalizer)."""
    b, t_local, h, d = q.shape
    n, my = group_size(group), group_rank(group)
    o = torch.zeros((b, h, t_local, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, t_local), -math.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, t_local), dtype=torch.float32, device=q.device)
    for i in range(n):
        # blocks rotate j -> j + 1 each step: at step i this rank holds
        # the block that started on rank (my - i) mod n
        src = (my - i) % n
        o, m, l = _ring_step(o, m, l, q, k, v, scale=scale, causal=causal, my=my, src=src,
                             t_local=t_local)
        if i < n - 1:
            k, v = ppermute((k, v), 1, group, chain=chain)
    out = o / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def _local_ring_flash(q, k, v, *, group, chain, causal, scale):
    """This rank's block through the ring with the flash kernels as the
    inner block (``flash_attention_lse``: the CUDA kernels on the card,
    their plain versions on the CPU), merged through the lse:
    ``o = o*exp(lse - lse_new) + o_blk*exp(lse_blk - lse_new)``."""
    b, t_local, h, d = q.shape
    n, my = group_size(group), group_rank(group)
    o = torch.zeros((b, t_local, h, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, t_local, h), -math.inf, dtype=torch.float32, device=q.device)
    for i in range(n):
        src = (my - i) % n
        if not causal or src < my:  # every key in the past: no mask
            o_blk, lse_blk = flash_attention_lse(q, k, v, causal=False, scale=scale)
        elif src == my:  # the diagonal: local causal is global causal
            o_blk, lse_blk = flash_attention_lse(q, k, v, causal=True, scale=scale)
        else:  # a future block: zero mass (its merge leaves o and lse as they
            # are), and no kernel runs
            o_blk = None
        if o_blk is not None:
            lse_new = torch.logaddexp(lse, lse_blk)
            w_old = torch.exp(lse - lse_new)[..., None]
            w_blk = torch.exp(lse_blk - lse_new)[..., None]
            o = o * w_old + o_blk.float() * w_blk
            lse = lse_new
        if i < n - 1:
            k, v = ppermute((k, v), 1, group, chain=chain)
    return o.to(q.dtype)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mesh,
    axis: str = SEQ_AXIS,
    causal: bool = False,
    scale: Optional[float] = None,
    inner: str = "dense",
) -> torch.Tensor:
    """Attention with the sequence split over ``mesh``'s axis ``axis``.

    ``q``/``k``/``v``: this rank's sequence block ``[B, T/n, H, D]`` (the
    rank at position ``j`` of the axis holds positions ``[j*T/n,
    (j+1)*T/n)``); returns this rank's block of the output, in ``q``'s
    dtype (the merge runs in float32).  ``inner="flash"`` runs each block
    through the flash kernels (the diagonal causal, a past block whole, a
    future block skipped); ``"dense"`` through plain PyTorch.  A group of
    one is plain attention."""
    chain = Chain()
    out = ring_blocks(q, k, v, group=axis_group(mesh, axis), chain=chain, causal=causal,
                      scale=scale, inner=inner)
    return chain.join(out)


def ring_blocks(q, k, v, *, group, chain: Chain, causal: bool = False,
                scale: Optional[float] = None, inner: str = "dense") -> torch.Tensor:
    """:func:`ring_attention` over a process group (None: a ring of one),
    its exchanges on ``chain``, which the caller joins into its result."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if inner not in ("dense", "flash"):
        raise ValueError(f"inner={inner!r}: want 'dense' or 'flash'")
    local = _local_ring_flash if inner == "flash" else _local_ring
    return local(q, k, v, group=group, chain=chain, causal=causal, scale=float(scale))
