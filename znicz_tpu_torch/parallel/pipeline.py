"""Pipeline parallelism: the GPipe microbatched stage pipeline (port of
``znicz_tpu/parallel/pipeline.py``).

S identically shaped stages are stacked (each leaf carries a leading
stage dim) and split over the mesh's ``pipe`` axis: the rank at pipe
position ``s`` holds stage ``s``'s block ``[1, ...]`` of every stacked leaf
(as ``DataParallel.shard_state`` holds a sharded leaf), and runs it.  One
process runs one device, so the JAX package's ``shard_map`` body is this
rank's program here, and its ``ppermute`` hops are
:func:`~znicz_tpu_torch.parallel.tensor_parallel.ppermute` exchanges over
the rank's pipe group.

The JAX package's memory contract holds: each rank stores ``ceil(M/S)``
input and output microbatches, not the batch.  The stores are the JAX
package's circular conveyors: every tick one input slot and one output
slot travel a hop backward while the activations travel a hop forward,
timed so stage 0 finds microbatch ``t`` in its slot ``t % C`` at tick
``t`` and finished chunk ``q`` ends on rank ``q``.  The rank's input
chunk is its block of the padded microbatch store (forward a slice,
backward an all-gather), and the finished chunks are all-gathered for
the head (forward an all-gather, backward the rank's slice).

Schedule: S + M' - 1 ticks (M' the microbatch count padded to a multiple
of S); at tick t stage s works on microbatch ``t - s`` when ``0 <= t - s <
M``.  Whether a tick is active is a host integer here, so an idle stage
skips its compute; it never skips its exchange.  A tick's hops travel in
one exchange, moved from the JAX package's start of the next tick to the
end of this one (nothing touches the slot between), and hops that carry
nothing any rank reads (the output slots before the first finished chunk
reaches them, input slots past their last read) are left out on every
rank alike.  All of them ride one
:class:`~znicz_tpu_torch.parallel.tensor_parallel.Chain`, so the backward,
autograd's transpose of this program, runs them in reverse on every rank
whatever each stage computed.

With ``data_axis`` each data row runs its own pipeline over its rows.
The JAX package's microbatch ``i`` is global rows ``[i*mb, (i+1)*mb)``
split over the data axis, while a data rank here holds a contiguous block
of the batch: the rows are regrouped over the data group before the
pipeline and back after it (an all-gather each way), so every microbatch
holds the JAX package's rows (a capacity MoE drops tokens by the group it
sees).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict

import numpy as np
import torch

from znicz_tpu_torch.parallel.data_parallel import _leaves, _map, axis_group, axis_index
from znicz_tpu_torch.parallel.mesh import PIPE_AXIS, axis_size
from znicz_tpu_torch.parallel.tensor_parallel import (
    Chain,
    all_gather,
    gather_from_model,
    group_size,
    local_slice,
    ppermute,
    route_rows,
    scatter_to_model,
    spec_dims,
)


def _tree_stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return [_tree_stack([t[i] for t in trees]) for i in range(len(first))]
    return torch.stack(trees)


def stack_stage_params(per_stage_params) -> Any:
    """``[{...}, {...}, ...]`` (same shapes) -> one tree whose leaves carry
    a leading stage dim S."""
    return _tree_stack(list(per_stage_params))


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    """Idle fraction of the GPipe schedule: (S-1)/(S-1+M') with M' the
    microbatch count padded up to a multiple of S.  Drive it down by
    raising ``n_microbatches``."""
    m_pad = n_stages * int(np.ceil(n_microbatches / n_stages))
    return (n_stages - 1) / (n_stages - 1 + m_pad)


def _local_pipeline(params, x, *, apply_one, group, n_micro, n_stages, stage, chain):
    """This rank's program: ``params`` its stage's params (the stage dim
    taken off), ``x`` [C, mb, ...] its chunk of the microbatch store (C =
    M'/S); returns its chunk of finished microbatches [C, mb, ...]."""
    chunk = x.shape[0]
    if chunk * n_stages < n_micro:
        raise AssertionError(
            "per-device microbatch storage must be the padded chunk "
            f"ceil(M/S): got {chunk} for M={n_micro}, S={n_stages}"
        )
    m_pad = chunk * n_stages
    n_ticks = n_stages + m_pad - 1
    x_store = list(x.unbind(0))
    out_store = [torch.zeros_like(x_store[0]) for _ in range(chunk)]
    buf = None
    for t in range(n_ticks):
        m = t - (n_stages - 1)  # the microbatch the last stage finishes now
        out = None
        if 0 <= t - stage < n_micro:
            out = apply_one(params, x_store[t % chunk] if stage == 0 else buf)
        if stage == n_stages - 1 and 0 <= m < n_micro:
            out_store[m % chunk] = out  # banked into the output conveyor
        # the tick's one exchange: the activation a hop forward, while a
        # later stage works at t + 1; the input slot a hop backward, while
        # stage 0 reads it again; the output slot that the next tick
        # rotates (JAX's rotation at its start), once one holds a result
        sends, shifts, slots = [], [], []
        if n_stages > 1 and t <= n_micro + n_stages - 3:
            sends.append(out if out is not None else torch.zeros_like(x_store[0]))
            shifts.append(1)
            slots.append(("act", None))
        if t + chunk <= n_micro - 1:
            sends.append(x_store[t % chunk])
            shifts.append(-1)
            slots.append(("in", t % chunk))
        if chunk <= m + 1 <= m_pad - 1:
            sends.append(out_store[(m + 1) % chunk])
            shifts.append(-1)
            slots.append(("out", (m + 1) % chunk))
        if not sends:
            continue
        for (kind, slot), got in zip(slots, ppermute(sends, shifts, group, chain=chain)):
            if kind == "act":
                buf = got
            elif kind == "in":
                x_store[slot] = got
            else:
                out_store[slot] = got
    return torch.stack(out_store)


def _regroup_rows(x, group, n_micro, *, inverse, chain):
    """This data rank's contiguous rows ``x`` regrouped so that its local
    microbatch ``i`` holds the JAX package's rows of global microbatch
    ``i`` (rows ``[i*mb + d*mb/D, i*mb + (d+1)*mb/D)`` for data rank
    ``d``); ``inverse`` undoes it.  Each way one :func:`route_rows` over
    the data group, each rank sent only the rows it takes; the identity
    where the two agree."""
    n = group_size(group)
    rows = x.shape[0]
    total = rows * n
    mb = total // n_micro
    # jax_rows[d] lists rank d's JAX rows, in its microbatch order
    jax_rows = [[i * mb + d * (mb // n) + j for i in range(n_micro) for j in range(mb // n)]
                for d in range(n)]
    if all(r == list(range(d * rows, (d + 1) * rows)) for d, r in enumerate(jax_rows)):
        return x  # one microbatch: every rank's rows are its own
    # own_rows[d]: where rank d's own rows sit among the JAX-ordered ones
    pos = np.empty(total, np.int64)
    pos[np.concatenate(jax_rows)] = np.arange(total)
    own_rows = [pos[d * rows:(d + 1) * rows].tolist() for d in range(n)]
    fwd, bwd = (own_rows, jax_rows) if inverse else (jax_rows, own_rows)
    (y,) = chain.exchange(lambda xs: [route_rows(xs[0], fwd, group)],
                          lambda gs: [route_rows(gs[0], bwd, group)], [x])
    return y


def _take_stage(stacked, mesh, axis, param_spec_fn, chain):
    """This rank's blocks of whole stacked leaves ([S, ...]; model blocks
    too where ``param_spec_fn``'s spec names the model axis), as one
    exchange: forward the slices, backward the gradients gathered whole
    (so a whole leaf's gradient is whole on every rank, as the JAX
    package's)."""
    paths = [p for p, _ in _leaves(stacked)]
    leaves = [leaf for _, leaf in _leaves(stacked)]
    dims = []
    for path, leaf in zip(paths, leaves):
        spec = (param_spec_fn(path, leaf) if param_spec_fn is not None
                else (axis,) + (None,) * (leaf.ndim - 1))
        dims.append([(axis_group(mesh, a), d) for a, d in
                     sorted(spec_dims(spec).items(), key=lambda ad: ad[0] != PIPE_AXIS)
                     if axis_size(mesh, a) > 1])

    def take(xs):
        out = []
        for x, ds in zip(xs, dims):
            for group, d in ds:
                x = local_slice(x, d, group)
            out.append(x.contiguous())
        return out

    def whole(gs):
        out = []
        for g, ds in zip(gs, dims):
            for group, d in reversed(ds):
                g = all_gather(g, d, group)
            out.append(g)
        return out

    blocks = iter(chain.exchange(take, whole, leaves))
    by_path = {p: next(blocks) for p in paths}
    return _map(lambda path, leaf: by_path[path], stacked)


def pipeline_apply(
    stacked_params,
    x: torch.Tensor,
    *,
    apply_one: Callable,
    mesh,
    n_microbatches: int,
    axis: str = PIPE_AXIS,
    data_axis: str = None,
    param_spec_fn=None,
    check_vma: bool = True,
) -> torch.Tensor:
    """Run ``x`` [B, F...] through the stacked stages, pipelined over
    ``mesh``'s axis ``axis``.

    ``apply_one(stage_params, x_mb)`` applies one stage to one microbatch.
    ``stacked_params``: leaves of stage dim S, whole (this rank takes its
    stage, and its model block where ``param_spec_fn`` says, and their
    gradients come back whole), or of stage dim 1, this rank's blocks (as
    :func:`shard_stacked_params` and the workflows' placement hold them;
    their gradients are the blocks').  ``x``: the batch, or with
    ``data_axis`` this data rank's contiguous rows of it; B must divide by
    ``n_microbatches`` and, with ``data_axis``, a microbatch's rows by the
    data axis.  ``param_spec_fn(path, leaf) -> spec`` places a whole
    stacked leaf (default ``P(pipe, None, ...)``); a spec naming the
    ``model`` axis hands ``apply_one`` model-local weights, which must
    contract locally and sum over that axis itself.  ``check_vma`` is
    accepted and ignored (no ``shard_map`` runs here)."""
    del check_vma
    n_stages = axis_size(mesh, axis)
    b = x.shape[0]
    group_d = None
    if data_axis is not None:
        n_data = axis_size(mesh, data_axis)
        b = x.shape[0] * n_data  # this rank holds its data row's 1/D
        mb = b // n_microbatches
        if mb % n_data:
            raise ValueError(
                f"microbatch rows {mb} not divisible by data axis "
                f"{n_data} (batch {b}, M={n_microbatches})"
            )
        group_d = axis_group(mesh, data_axis)
    stage_dims = {leaf.shape[0] for _, leaf in _leaves(stacked_params)}
    if not (stage_dims == {n_stages} or stage_dims == {1}):
        raise ValueError(
            f"stacked params have stage dim(s) {sorted(stage_dims)} but "
            f"mesh axis {axis!r} has {n_stages} devices"
        )
    if b % n_microbatches:
        raise ValueError(
            f"batch {b} not divisible by n_microbatches {n_microbatches}"
        )
    chain = Chain()
    if stage_dims == {n_stages} and n_stages > 1:
        stacked_params = _take_stage(stacked_params, mesh, axis, param_spec_fn, chain)
    group = axis_group(mesh, axis)
    if group_d is not None and group_size(group_d) > 1:
        x = _regroup_rows(x, group_d, n_microbatches, inverse=False, chain=chain)
    rows = x.shape[0]
    micro = x.reshape((n_microbatches, rows // n_microbatches) + tuple(x.shape[1:]))
    # pad the store up to a multiple of S so each rank holds an equal
    # chunk; padded microbatches are never computed or kept
    chunk = int(math.ceil(n_microbatches / n_stages))
    m_pad = chunk * n_stages
    if m_pad != n_microbatches:
        micro = torch.cat([micro, micro.new_zeros((m_pad - n_microbatches,) + micro.shape[1:])])
    store = scatter_to_model(micro, 0, group, chain=chain)
    stage_params = _map(lambda _, leaf: leaf[0], stacked_params)
    out = _local_pipeline(stage_params, store, apply_one=apply_one, group=group,
                          n_micro=n_microbatches, n_stages=n_stages,
                          stage=axis_index(mesh, axis), chain=chain)
    out = gather_from_model(out, 0, group, chain=chain)[:n_microbatches]
    out = out.reshape((rows,) + tuple(out.shape[2:]))
    if group_d is not None and group_size(group_d) > 1:
        out = _regroup_rows(out, group_d, n_microbatches, inverse=True, chain=chain)
    return chain.join(out)


def pipelined_model_apply(
    params: Dict[str, Any],
    x: torch.Tensor,
    *,
    embed_fn: Callable,
    stage_fn: Callable,
    head_fn: Callable,
    mesh,
    n_microbatches: int,
    axis: str = PIPE_AXIS,
    data_axis: str = None,
    param_spec_fn=None,
    check_vma: bool = True,
) -> torch.Tensor:
    """Embed -> pipelined tower -> head.  ``params`` = ``{"embed",
    "stages", "head"}``; embed and head run on every rank of the pipe axis
    (whole), only the identically shaped tower pipelines."""
    h = embed_fn(params["embed"], x)
    h = pipeline_apply(
        params["stages"], h,
        apply_one=stage_fn, mesh=mesh,
        n_microbatches=n_microbatches, axis=axis, data_axis=data_axis,
        param_spec_fn=param_spec_fn, check_vma=check_vma,
    )
    return head_fn(params["head"], h)


def shard_stacked_params(stacked_params, mesh, axis: str = PIPE_AXIS):
    """This rank's stage block ``[1, ...]`` of every stacked leaf (the
    stage dim split over ``axis``)."""
    group = axis_group(mesh, axis)
    if axis_size(mesh, axis) == 1:
        return stacked_params
    return _map(lambda _, leaf: local_slice(leaf.detach(), 0, group).clone()
                .requires_grad_(leaf.requires_grad), stacked_params)
