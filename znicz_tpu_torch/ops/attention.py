"""Scaled dot-product and multi-head attention (port of
``znicz_tpu/ops/attention.py``).

Layouts: ``q/k/v`` are ``[batch, seq, heads, head_dim]`` (BTHD).  Scores
and the value product accumulate in f32 whatever the input dtype (JAX's
``preferred_element_type``).  The products are ``torch.einsum`` /
``torch.matmul``, as the JAX package left them to XLA; the blockwise kernel
twin is :func:`znicz_tpu_torch.ops.kernels.attention.flash_attention`.
:func:`paged_attention` is the block-table attention of paged decoding, plain
torch as the JAX package's is jnp (its Pallas twin was never written).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from znicz_tpu_torch.core import device as device_lib, prng
from znicz_tpu_torch.ops.filling import fill


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Stable softmax attention; returns [B, Tq, H, D] in q's dtype."""
    if scale is None:
        scale = 1.0 / np.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        mask = torch.ones((tq, tk), dtype=torch.bool, device=s.device).tril(tk - tq)
        s = torch.where(mask, s, -torch.inf)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def masked_attention(
    q: torch.Tensor,  # [B, Tq, H, D]
    k: torch.Tensor,  # [B, Tk, H, D]
    v: torch.Tensor,
    q_pos: torch.Tensor,  # [B or 1, Tq] integer absolute query positions
    *,
    start: Optional[torch.Tensor] = None,  # [B] first real position
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention over keys at absolute positions ``0..Tk-1``, valid where
    ``<= q_pos`` and, under left-padding, ``>= start`` (a pad-region query
    keeps its own position so its softmax stays finite); returns [B, Tq, H,
    D].  The decode cache's and the paged pools' one attention: f32 scores,
    stable softmax, f32 value product."""
    if scale is None:
        scale = 1.0 / np.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    k_idx = torch.arange(k.shape[1], device=q.device)[None, None, None, :]
    qp = q_pos[:, None, :, None]
    valid = k_idx <= qp
    if start is not None:
        valid = valid & (k_idx >= torch.minimum(start[:, None, None, None], qp))
    s = torch.where(valid, s, -torch.inf)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def paged_attention(
    q: torch.Tensor,  # [B, Tq, H, D]
    k_pool: torch.Tensor,  # [N_blocks, block_size, H, D]
    v_pool: torch.Tensor,
    block_table: torch.Tensor,  # [B, M] integer pool block ids
    q_pos: torch.Tensor,  # [B, Tq] integer absolute query positions
    *,
    block_size: int,
    start: Optional[torch.Tensor] = None,  # [B] first real position
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Block-table attention over paged KV pools; returns [B, Tq, H, D].

    Table entry ``j`` of a row covers its absolute positions ``j*block_size
    .. (j+1)*block_size-1``; the row's window is gathered from the pool
    (``k_pool[block_table]``), so many tables may reference one block
    (prefix sharing) and each row reads it through its own table.
    Validity is by absolute key index (:func:`masked_attention`), so stale
    or unallocated entries are masked by index, never read through."""
    b = q.shape[0]
    m = block_table.shape[1]
    # [B, M, bs, H, D] -> [B, M*bs, H, D]: the row-ordered KV window
    k = k_pool[block_table].reshape(b, m * block_size, *k_pool.shape[2:])
    v = v_pool[block_table].reshape(b, m * block_size, *v_pool.shape[2:])
    return masked_attention(q, k, v, q_pos, start=start, scale=scale)


def init_mha_params(
    d_model: int,
    n_heads: int,
    *,
    head_dim: Optional[int] = None,
    weights_stddev: Optional[float] = None,
    weights_filling: str = "gaussian",
    rand_name: str = "default",
    dtype: torch.dtype = torch.float32,
    device: device_lib.DeviceLike = None,
) -> Dict[str, torch.Tensor]:
    """``wq, wk, wv`` ``[d_model, H*hd]`` and ``wo`` ``[H*hd, d_model]``,
    drawn in that order from the named numpy stream (the JAX package's
    order, so the same seed gives the same weights), on ``device`` (None:
    the card, raising without one)."""
    dev = device_lib.resolve(device)
    gen = prng.get(rand_name)
    head_dim = head_dim or d_model // n_heads
    if weights_stddev is None:
        weights_stddev = 1.0 / np.sqrt(d_model)
    inner = n_heads * head_dim
    shapes = {"wq": (d_model, inner), "wk": (d_model, inner),
              "wv": (d_model, inner), "wo": (inner, d_model)}
    return {
        name: torch.from_numpy(fill(gen, shape, weights_filling, weights_stddev)).to(dev, dtype)
        for name, shape in shapes.items()
    }


def mha(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,  # [B, T, d_model]
    *,
    n_heads: int,
    causal: bool = False,
    attention_fn=dot_product_attention,
) -> torch.Tensor:
    """Multi-head self-attention block: projections (f32 results cast back
    to x's dtype), ``attention_fn`` over BTHD heads, output projection."""
    b, t, _ = x.shape

    def proj(w):
        y = torch.matmul(x.float(), w.float()).to(x.dtype)
        return y.reshape(b, t, n_heads, -1)

    q, k, v = proj(params["wq"]), proj(params["wk"]), proj(params["wv"])
    o = attention_fn(q, k, v, causal=causal).reshape(b, t, -1)
    return torch.matmul(o.float(), params["wo"].float()).to(x.dtype)
