"""Mixture-of-experts FC layer (port of ``znicz_tpu/ops/moe.py``).

Two dispatch modes, as in the JAX package:

* ``"dense"``: every expert computes every token and a top-k gate matrix
  masks the combination (``[E, B, H]`` activations; right for a few
  experts).
* ``"capacity"``: GShard-style capacity-bounded dispatch.  Each expert
  takes at most ``C = ceil(k*B/E * capacity_factor)`` tokens; the (token,
  choice) pairs are stably sorted by expert, their slot inside the expert
  comes from a ``searchsorted`` against the segment starts, and dispatch
  and combine are a scatter-add into ``[E*C + 1, F]`` (the last row the
  drop slot) and a gather back.  Slot priority is (choice rank, token
  index).  Over-capacity choices contribute 0.

Top-k ties go to the lower expert index (a stable descending sort, as
``jax.lax.top_k``): a zero row activates the first ``k`` experts.  Every
shape is static and nothing reads the device from the host, so an MoE
step is captured into a CUDA graph as a dense one is.  The combine's
``index_add_`` adds a token's ``k`` contributions with atomics on the
card, so a capacity step agrees with another to a float32 sum's order,
not bitwise.  The products are ``torch.matmul`` (cuBLAS on the card), as
the JAX package left its einsums to XLA.

Expert parallelism (``apply_local_shard``, ``expert_sharding``) is not
ported and raises, naming its ROADMAP.md item.
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional

import numpy as np
import torch

from znicz_tpu_torch.core import device as device_lib, prng
from znicz_tpu_torch.ops.filling import fill, to_param

DISPATCHES = ("dense", "capacity")


def init_params(
    n_input: int,
    n_hidden: int,
    n_experts: int,
    *,
    weights_stddev: Optional[float] = None,
    weights_filling: str = "gaussian",
    rand_name: str = "default",
    dtype=torch.float32,
    device: device_lib.DeviceLike = None,
) -> Dict[str, torch.Tensor]:
    """``router [F, E]``, ``w1 [E, F, H]``, ``b1 [E, H]``, ``w2 [E, H, F]``,
    ``b2 [E, F]``, drawn router, w1, w2 from the named numpy stream (the JAX
    package's order), on ``device`` (None: the card, raising without one)."""
    dev = device_lib.resolve(device)
    gen = prng.get(rand_name)
    if weights_stddev is None:
        weights_stddev = 1.0 / np.sqrt(n_input)
    router = fill(gen, (n_input, n_experts), weights_filling, weights_stddev)
    w1 = fill(gen, (n_experts, n_input, n_hidden), weights_filling, weights_stddev)
    w2 = fill(gen, (n_experts, n_hidden, n_input), weights_filling, 1.0 / np.sqrt(n_hidden))
    return {
        "router": to_param(router, dev, dtype),
        "w1": to_param(w1, dev, dtype),
        "b1": torch.zeros((n_experts, n_hidden), dtype=dtype, device=dev),
        "w2": to_param(w2, dev, dtype),
        "b2": torch.zeros((n_experts, n_input), dtype=dtype, device=dev),
    }


def apply(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,  # [B, F]
    *,
    top_k: int = 1,
    dispatch: str = "dense",
    capacity_factor: float = 1.25,
) -> torch.Tensor:
    """Gated expert combination; returns ``[B, F]`` in x's dtype.

    Gate: softmax over the top-k router logits of a token (renormalised),
    zero elsewhere.  ``dispatch``: "dense" or "capacity" (see the module
    docstring); "capacity" with ``top_k >= E`` warns and runs the dense
    path, as the JAX package does."""
    logits = x @ params["router"]  # [B, E]
    e = logits.shape[-1]
    if dispatch == "capacity" and top_k < e:
        return _capacity_apply(params, x, logits, top_k=top_k, capacity_factor=capacity_factor)
    if dispatch not in DISPATCHES:
        raise ValueError(f"unknown dispatch mode {dispatch!r}")
    if dispatch == "capacity":  # top_k >= e: capacity has no meaning
        warnings.warn(
            f"dispatch='capacity' with top_k={top_k} >= n_experts={e} "
            "degrades to the dense path (full softmax gates, no token "
            "drop); lower top_k for capacity semantics",
            stacklevel=2,
        )
    gates = _dense_gates(logits, top_k)
    out = torch.einsum("be,ebf->bf", gates, _dense_expert_outputs(params, x))
    return out.to(x.dtype)


def _top_k(logits: torch.Tensor, k: int):
    """``(values, indices)`` of the ``k`` largest logits a row, descending,
    ties to the lower index (``jax.lax.top_k``'s order; ``torch.topk``
    promises none)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dense_gates(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """``[B, E]`` top-k gate matrix: softmax over the top-k logits a token,
    zero elsewhere (exact membership by index: a threshold would activate
    every tied expert of a zero row)."""
    if top_k >= logits.shape[-1]:
        return torch.softmax(logits, dim=-1)
    top_vals, top_idx = _top_k(logits, top_k)
    g = torch.softmax(top_vals, dim=-1)  # [B, k]
    return torch.zeros_like(logits).scatter(-1, top_idx, g)


def _dense_expert_outputs(params, x: torch.Tensor) -> torch.Tensor:
    """``[E, B, F]``: every expert's biased output for every token."""
    h = torch.tanh(torch.matmul(x, params["w1"]) + params["b1"][:, None, :])
    return torch.matmul(h, params["w2"]) + params["b2"][:, None, :]


def expert_capacity(batch: int, n_experts: int, top_k: int, capacity_factor: float) -> int:
    """Per-expert token budget C (a Python int: every shape stays static)."""
    return max(1, int(np.ceil(top_k * batch / n_experts * capacity_factor)))


def _capacity_apply(params, x, logits, *, top_k, capacity_factor):
    """Sort/segment dispatch, working set O(B*k*F + E*C*F): no ``[B, E,
    C]`` one-hot tensors.  Gradients flow through the gates, the
    dispatched activations and the expert outputs (the routing indices
    carry none), as in the JAX package."""
    b, e = logits.shape
    f = x.shape[1]
    kb = top_k * b
    cap = expert_capacity(b, e, top_k, capacity_factor)
    top_vals, top_idx = _top_k(logits, top_k)  # [B, k]
    g = torch.softmax(top_vals, dim=-1)
    # choice-major flattening (flat index = rank*B + token), so the stable
    # sort keeps (choice rank, token index) slot priority
    eid = top_idx.t().reshape(-1)  # [kB] expert of each choice
    tok = torch.arange(b, device=x.device).repeat(top_k)  # [kB]
    gate = g.t().reshape(-1)
    order = torch.argsort(eid, stable=True)
    eid_s = eid[order]
    # the slot inside the expert's buffer: the rank within its segment
    first = torch.searchsorted(eid_s, eid_s, side="left")
    pos_s = torch.arange(kb, device=x.device) - first
    # over-capacity choices go to the trailing drop slot (row e*cap)
    dest_s = torch.where(pos_s < cap, eid_s * cap + pos_s, torch.full_like(pos_s, e * cap))
    tok_s = tok[order]
    xe = torch.zeros((e * cap + 1, f), dtype=x.dtype, device=x.device)
    xe = xe.index_add(0, dest_s, x.index_select(0, tok_s))  # unique slots but the drop slot
    xe = xe[:-1].reshape(e, cap, f)
    h = torch.tanh(torch.matmul(xe, params["w1"]) + params["b1"][:, None, :])
    y = torch.matmul(h, params["w2"]) + params["b2"][:, None, :]
    y_flat = torch.cat([y.reshape(e * cap, f), y.new_zeros((1, f))])
    contrib = y_flat.index_select(0, dest_s) * gate[order].to(y.dtype)[:, None]
    out = torch.zeros((b, f), dtype=y.dtype, device=x.device).index_add(0, tok_s, contrib)
    return out.to(x.dtype)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} (expert parallelism) is not ported to znicz_tpu_torch yet "
        "(ROADMAP.md A6, ops/moe.py)"
    )


def apply_local_shard(*args, **kwargs):
    """One expert shard's dense-dispatch contribution under manual expert
    parallelism: not ported (ROADMAP.md A6)."""
    raise _not_ported("moe.apply_local_shard")


def expert_sharding(*args, **kwargs):
    """Expert-dim placement over a device mesh: not ported (ROADMAP.md
    A6)."""
    raise _not_ported("moe.expert_sharding")
