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

Expert parallelism: :func:`expert_sharding` places each rank's
contiguous block of ``E / n_model`` experts (the router whole), and
:func:`apply_local_shard` (dense) and :func:`apply_parallel` (both
dispatches) give one shard's contribution; summed over the model axis
they are :func:`apply`.  Every rank routes over all ``E`` experts with the
whole router, so the gates and the capacity slots are the same on every
shard, and each shard computes its own experts' slots only.  Capacity
over a batch split on the data axis (``data_group``) takes its slots from
the global batch, as the JAX package's sort over the global batch does:
the ranks' top-k expert ids are all-gathered (integers, no gradient) in
the global choice-major order, each choice's slot is its rank within its
expert over the global order, and ``C`` is the global batch's.
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional

import numpy as np
import torch

from znicz_tpu_torch.core import device as device_lib, prng
from znicz_tpu_torch.ops.filling import fill, to_param
from znicz_tpu_torch.parallel import tensor_parallel as tp_ops

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
    return apply_parallel(params, x, top_k=top_k, dispatch=dispatch,
                          capacity_factor=capacity_factor)


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


def apply_local_shard(
    params_local: Dict[str, torch.Tensor],
    x: torch.Tensor,  # [B, F]
    *,
    top_k: int,
    shard_index,
) -> torch.Tensor:
    """ONE expert shard's dense-dispatch contribution: ``params_local``'s
    expert leaves (w1/b1/w2/b2) hold shard ``shard_index``'s ``E_local``
    contiguous experts and the router is whole, so the top-k gate over all
    ``E`` experts is the same on every shard and this shard weights only
    its own gate columns.  The shards' contributions sum to :func:`apply`'s
    dense dispatch (b2 is gate-weighted per expert, so its partials sum
    too)."""
    logits = x @ params_local["router"]  # [B, E], router whole
    e_local = params_local["w1"].shape[0]
    lo = int(shard_index) * e_local
    gates_local = _dense_gates(logits, top_k)[:, lo:lo + e_local]
    out = torch.einsum("be,ebf->bf", gates_local, _dense_expert_outputs(params_local, x))
    return out.to(x.dtype)


def apply_parallel(
    params_local: Dict[str, torch.Tensor],
    x: torch.Tensor,  # [B, F]: this rank's rows of the batch
    *,
    top_k: int = 1,
    dispatch: str = "dense",
    capacity_factor: float = 1.25,
    shard_index: int = 0,
    data_group=None,
) -> torch.Tensor:
    """One expert shard's contribution (:func:`apply_local_shard`'s
    ``params_local`` and ``shard_index``) in either dispatch, for this
    rank's rows of a batch split over ``data_group`` (None: the batch is
    whole here).  Summed over the shards, the rows are :func:`apply`'s on
    the global batch (capacity's slots and ``C`` are the global batch's)."""
    e = params_local["router"].shape[-1]
    if dispatch not in DISPATCHES:
        raise ValueError(f"unknown dispatch mode {dispatch!r}")
    if dispatch == "dense" or top_k >= e:
        if dispatch == "capacity":
            warnings.warn(
                f"dispatch='capacity' with top_k={top_k} >= n_experts={e} "
                "degrades to the dense path (full softmax gates, no token "
                "drop); lower top_k for capacity semantics",
                stacklevel=2,
            )
        return apply_local_shard(params_local, x, top_k=top_k, shard_index=shard_index)
    return _capacity_apply(params_local, x, x @ params_local["router"], top_k=top_k,
                           capacity_factor=capacity_factor, shard_index=shard_index,
                           data_group=data_group)


def _global_slots(eid: torch.Tensor, data_group):
    """``(slot of each of this rank's choices, the global batch)``: ``eid``
    is the rank's ``[k, B]`` expert ids (choice-major); the slot
    is the choice's rank within its expert over the global choice-major
    order (choice rank, then global token ``d * B + i``), the stable
    sort's segment rank."""
    k, b = eid.shape
    n = tp_ops.group_size(data_group)
    if n > 1:
        eid_all = tp_ops.all_gather(eid, 1, data_group)  # [k, n*B]
        d = tp_ops.group_rank(data_group)
    else:
        eid_all, d = eid, 0
    flat = eid_all.reshape(-1)
    order = torch.argsort(flat, stable=True)
    sorted_ids = flat[order]
    first = torch.searchsorted(sorted_ids, sorted_ids, side="left")
    slot = torch.empty_like(flat)
    slot[order] = torch.arange(flat.numel(), device=flat.device) - first
    mine = slot.view(k, n * b)[:, d * b:(d + 1) * b].reshape(-1)
    return mine, n * b


def _capacity_apply(params, x, logits, *, top_k, capacity_factor, shard_index=0,
                    data_group=None):
    """Sort/segment dispatch, working set O(B*k*F + E*C*F): no ``[B, E,
    C]`` one-hot tensors.  Each choice's slot inside its expert is its rank
    within the expert over the (global) choice-major order
    (:func:`_global_slots`); ``params``' experts are shard
    ``shard_index``'s block (all of them by default), and choices of other
    experts or over capacity go to the trailing drop slot.  Gradients flow
    through the gates, the dispatched activations and the expert outputs
    (the routing indices carry none), as in the JAX package."""
    b, e = logits.shape
    f = x.shape[1]
    e_local = params["w1"].shape[0]
    lo = int(shard_index) * e_local
    top_vals, top_idx = _top_k(logits, top_k)  # [B, k]
    g = torch.softmax(top_vals, dim=-1)
    eid = top_idx.t().contiguous()  # [k, B], choice-major
    slot, global_b = _global_slots(eid, data_group)
    cap = expert_capacity(global_b, e, top_k, capacity_factor)
    eid = eid.reshape(-1)
    tok = torch.arange(b, device=x.device).repeat(top_k)
    gate = g.t().reshape(-1)
    drop = e_local * cap
    keep = (slot < cap) & (eid >= lo) & (eid < lo + e_local)
    dest = torch.where(keep, (eid - lo) * cap + slot, torch.full_like(slot, drop))
    xe = torch.zeros((drop + 1, f), dtype=x.dtype, device=x.device)
    xe = xe.index_add(0, dest, x.index_select(0, tok))  # unique slots but the drop slot
    xe = xe[:-1].reshape(e_local, cap, f)
    h = torch.tanh(torch.matmul(xe, params["w1"]) + params["b1"][:, None, :])
    y = torch.matmul(h, params["w2"]) + params["b2"][:, None, :]
    y_flat = torch.cat([y.reshape(drop, f), y.new_zeros((1, f))])
    contrib = y_flat.index_select(0, dest) * gate.to(y.dtype)[:, None]
    out = torch.zeros((b, f), dtype=y.dtype, device=x.device).index_add(0, tok, contrib)
    return out.to(x.dtype)


def expert_sharding(mesh, axis: str = "model"):
    """Expert-dim placement over a mesh axis (EP): returns ``place(params)``
    giving this rank's contiguous block of every expert leaf (dim 0) and
    the router whole."""
    from znicz_tpu_torch.parallel.mesh import axis_size

    names = list(mesh.mesh_dim_names)
    n = axis_size(mesh, axis)
    m = int(mesh.get_coordinate()[names.index(axis)]) if axis in names else 0

    def place(params):
        def put(name, leaf):
            if name == "router":
                return leaf
            if leaf.shape[0] % n:
                raise ValueError(f"{name}: {leaf.shape[0]} experts do not divide by the "
                                 f"{axis} axis {n}")
            step = leaf.shape[0] // n
            return leaf[m * step:(m + 1) * step]

        return {name: put(name, leaf) for name, leaf in params.items()}

    return place
