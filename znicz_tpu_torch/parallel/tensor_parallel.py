"""Megatron tensor parallelism over the mesh's ``model`` axis: the four
conjugate operators a sharded forward is written with, and the
placement spec.

The JAX package gets these collectives from GSPMD (the jitted step over
``DataParallel(tp=True)``'s shardings) or writes them as ``lax.psum`` in a
``shard_map`` (``workflow/transformer.py::_block_forward_tp``).  Here one
process runs one device, so a sharded leaf lives on rank ``(d, m)`` as its
``m``-th contiguous block along the sharded dim, and the forward calls the
collectives itself, over this rank's model group
(:func:`~znicz_tpu_torch.parallel.data_parallel.model_group`):

- :func:`copy_to_model`: forward the identity, backward an all-reduce (a
  whole input feeding a column-sharded layer: every rank's partial
  gradient of it is summed);
- :func:`reduce_from_model`: forward an all-reduce, backward the identity
  (a row-sharded layer's partial products);
- :func:`gather_from_model`: forward an all-gather along ``dim``, backward
  the rank's slice (a sharded activation made whole);
- :func:`scatter_to_model`: forward the rank's slice, backward an
  all-gather (a whole activation entering a row-sharded layer).

Each is the identity where the group is None (a model axis of 1).  The
collectives are ``all_reduce`` and the list form of ``all_gather``, which
gloo and NCCL both take on the card's tensors; low-precision floats travel
as float32.  ``torch.distributed.nn.functional.all_reduce`` is not
:func:`reduce_from_model`: its backward all-reduces again, which would
multiply the gradients by the model axis.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from znicz_tpu_torch.parallel.mesh import MODEL_AXIS


class PartitionSpec(tuple):
    """The port's counterpart of ``jax.sharding.PartitionSpec``: one mesh
    axis name or None a dim (trailing dims unnamed are whole); ``P()``
    keeps the leaf whole.  It is a tuple, so it compares equal to the JAX
    package's spec of the same entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


def sharded_dim(spec) -> Optional[int]:
    """The dim a spec shards over the model axis, or None for a whole
    leaf.  A spec naming another axis is not a placement this port
    makes."""
    dim = None
    for i, name in enumerate(spec or ()):
        if name is None:
            continue
        if name != MODEL_AXIS or dim is not None:
            raise ValueError(
                f"placement {spec!r}: the port shards a leaf along one dim over the "
                f"{MODEL_AXIS!r} axis (the batch rides the data axis)"
            )
        dim = i
    return dim


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the collective carries it: contiguous, low-precision floats
    as float32."""
    if x.is_floating_point() and x.element_size() < 4:
        x = x.float()
    return x.contiguous()


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``x`` reduced over ``group`` (``op`` "sum" or "max"), as a new
    tensor (no autograd)."""
    buf = _wire(x).clone()
    dist.all_reduce(buf, op=getattr(dist.ReduceOp, op.upper()), group=group)
    return buf.to(x.dtype)


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's ``x`` concatenated along ``dim`` in group-rank order (no
    autograd)."""
    buf = _wire(x)
    parts = [torch.empty_like(buf) for _ in range(group_size(group))]
    dist.all_gather(parts, buf, group=group)
    return torch.cat(parts, dim=dim).to(x.dtype)


def local_slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's contiguous block of ``x`` along ``dim``."""
    n = group_size(group)
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"dim {dim} of size {size} does not divide by the model axis {n}")
    step = size // n
    return x.narrow(dim, group_rank(group) * step, step)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return local_slice(g, ctx.dim, ctx.group).contiguous(), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return local_slice(x, dim, group).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.group), None, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Forward the identity, backward the gradient all-reduced over the
    model group."""
    return x if group is None else _Copy.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """Forward the sum over the model group, backward the identity."""
    return x if group is None else _Reduce.apply(x, group)


def gather_from_model(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Forward the model group's blocks concatenated along ``dim``,
    backward this rank's block of the gradient."""
    return x if group is None else _Gather.apply(x, dim % x.ndim, group)


def scatter_to_model(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Forward this rank's block along ``dim``, backward the gradient's
    blocks gathered."""
    return x if group is None else _Scatter.apply(x, dim % x.ndim, group)
