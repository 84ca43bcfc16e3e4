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

Each is the identity where the group is None (a model axis of 1), and
the last two take any group: the ring and the pipeline below use them on
their :class:`Chain`.  The
collectives are ``all_reduce`` and the list form of ``all_gather``, which
gloo and NCCL both take on the card's tensors; low-precision floats travel
as float32.  ``torch.distributed.nn.functional.all_reduce`` is not
:func:`reduce_from_model`: its backward all-reduces again, which would
multiply the gradients by the model axis.

Ring attention and the pipeline (``parallel/ring_attention.py``,
``parallel/pipeline.py``) move blocks between ranks with two more
conjugate exchanges, over any group:

- :func:`ppermute`: the JAX package's ``lax.ppermute`` on a ring, several
  tensors (each with its own shift) in one exchange; backward the opposite
  rotation.  It travels as one ``all_gather_into_tensor`` of the packed
  payloads, each rank keeping what its sources sent: gloo's point-to-point
  reads a card's pointer as a host address (``writev: Bad address``),
  while its all-gather stages through the host;
- :func:`all_to_all`: a re-layout (rows to sequence blocks), backward the
  inverse re-layout (``all_to_all_single``, which gloo takes on the card
  at equal splits).

:func:`route_rows` moves chosen rows between ranks in one
``all_to_all_single`` (the pipeline's regrouping of data rows into the
JAX package's microbatches).

Autograd runs a backward's exchanges in an order of its own choosing
wherever two of them do not depend on each other, and that order may
differ between ranks whose graphs differ (a stage that computes where
another idles, a ring block that is skipped): two exchanges would then
pair with the wrong peers' payloads, silently where the shapes agree.  A
:class:`Chain` threads a token through every exchange of one ring or
pipeline and into its output, so each exchange's backward waits for the
next one's and every rank walks them in reverse order, each exactly once.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch
import torch.distributed as dist

from znicz_tpu_torch.parallel.mesh import MODEL_AXIS, PIPE_AXIS


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


def spec_dims(spec) -> Dict[str, int]:
    """``{axis: dim}`` of a spec: each dim it shards and the axis it
    shards it over.  A leaf is sharded over the ``model`` axis and over
    the ``pipe`` axis (a stacked stage leaf) along one dim each at most;
    a spec naming another axis is not a placement this port makes."""
    dims: Dict[str, int] = {}
    for i, name in enumerate(spec or ()):
        if name is None:
            continue
        if name not in (MODEL_AXIS, PIPE_AXIS) or name in dims:
            raise ValueError(
                f"placement {spec!r}: the port shards a leaf along one dim over the "
                f"{MODEL_AXIS!r} axis and one over the {PIPE_AXIS!r} axis (the batch "
                "rides the data axis)"
            )
        dims[name] = i
    return dims


def sharded_dim(spec) -> Optional[int]:
    """The dim a spec shards over the model axis, or None."""
    return spec_dims(spec).get(MODEL_AXIS)


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
        raise ValueError(f"dim {dim} of size {size} does not divide by the group's {n} ranks")
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


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Forward the identity, backward the gradient all-reduced over the
    model group."""
    return x if group is None else _Copy.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """Forward the sum over the model group, backward the identity."""
    return x if group is None else _Reduce.apply(x, group)


def gather_from_model(x: torch.Tensor, dim: int, group, *,
                      chain: Optional[Chain] = None) -> torch.Tensor:
    """Forward the group's blocks concatenated along ``dim``, backward this
    rank's block of the gradient; an exchange on ``chain`` (a fresh one by
    default).  The identity over a group of one (None)."""
    if group_size(group) == 1:
        return x
    dim = dim % x.ndim
    (y,) = (chain or Chain()).exchange(
        lambda xs: [all_gather(xs[0], dim, group)],
        lambda gs: [local_slice(gs[0], dim, group).contiguous()], [x])
    return y


def scatter_to_model(x: torch.Tensor, dim: int, group, *,
                     chain: Optional[Chain] = None) -> torch.Tensor:
    """Forward this rank's block along ``dim``, backward the gradient's
    blocks gathered; an exchange on ``chain`` (a fresh one by default).
    The identity over a group of one (None)."""
    if group_size(group) == 1:
        return x
    dim = dim % x.ndim
    (y,) = (chain or Chain()).exchange(
        lambda xs: [local_slice(xs[0], dim, group).contiguous()],
        lambda gs: [all_gather(gs[0], dim, group)], [x])
    return y


# -- exchanges between the ranks of a ring or a pipeline --------------------

def _rotate(tensors: Sequence[torch.Tensor], shifts: Sequence[int], group) -> list:
    """Each of ``tensors`` as the rank ``shift`` places before this one on
    the group's ring holds it (rank ``i`` sends to ``(i + shift) % n``),
    all in one all-gather of one packed float32 buffer (no autograd)."""
    n, i = group_size(group), group_rank(group)
    flat = torch.cat([_wire(t).reshape(-1) for t in tensors])
    buf = torch.empty(n * flat.numel(), dtype=flat.dtype, device=flat.device)
    dist.all_gather_into_tensor(buf, flat, group=group)
    parts = buf.view(n, -1)
    out, off = [], 0
    for t, shift in zip(tensors, shifts):
        out.append(parts[(i - shift) % n, off:off + t.numel()].view(t.shape).to(t.dtype))
        off += t.numel()
    return out


def _relayout(x: torch.Tensor, split_dim: int, concat_dim: int, group) -> torch.Tensor:
    """``x`` cut into the group's ``n`` blocks along ``split_dim``, block
    ``j`` sent to rank ``j``, and the blocks received concatenated along
    ``concat_dim`` in rank order (no autograd)."""
    n = group_size(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of size {x.shape[split_dim]} does not divide "
                         f"by the group's {n} ranks")
    blocks = _wire(torch.stack(torch.chunk(x, n, dim=split_dim)))
    out = torch.empty_like(blocks)
    dist.all_to_all_single(out, blocks, group=group)
    return torch.cat(out.unbind(0), dim=concat_dim).to(x.dtype)


def route_rows(x: torch.Tensor, dst_rows: Sequence[Sequence[int]], group) -> torch.Tensor:
    """Rows moved between the group's ranks: rank ``d`` ends holding, in
    order, the rows ``dst_rows[d]`` of the ranks' blocks ``x`` concatenated
    in rank order (each rank holds as many as it gave).  One
    ``all_to_all_single`` at equal splits (gloo takes no other on the
    card): each pair of ranks exchanges a block of the most rows any pair
    exchanges, the rest zeros (no autograd)."""
    n, i = group_size(group), group_rank(group)
    rows = x.shape[0]
    sent = [[r - i * rows for r in want if r // rows == i] for want in dst_rows]
    width = max(sum(1 for r in want if r // rows == e) for want in dst_rows for e in range(n))
    send = _wire(x).new_zeros((n, width) + tuple(x.shape[1:]))
    for d, idx in enumerate(sent):
        send[d, :len(idx)] = _wire(x)[torch.as_tensor(idx, dtype=torch.long, device=x.device)]
    got = torch.empty_like(send)
    dist.all_to_all_single(got, send, group=group)
    seen = [0] * n
    take = []  # where each of this rank's rows arrived: (source rank, its k-th)
    for r in dst_rows[i]:
        e = r // rows
        take.append(e * width + seen[e])
        seen[e] += 1
    out = got.reshape((n * width,) + tuple(x.shape[1:]))
    return out[torch.as_tensor(take, dtype=torch.long, device=x.device)].to(x.dtype)


class _Exchange(torch.autograd.Function):
    """One exchange on a :class:`Chain`: ``fwd`` on the tensors, ``bwd``
    (its conjugate) on their gradients; the token passes through."""

    @staticmethod
    def forward(ctx, fwd, bwd, token, *xs):
        ctx.bwd = bwd
        return (token.new_zeros(()), *fwd(xs))

    @staticmethod
    def backward(ctx, g_token, *gs):
        return (None, None, g_token, *ctx.bwd(gs))


class Chain:
    """The exchanges of one ring or pipeline, threaded by a token in the
    order they run (see the module docstring); :meth:`join` ties the
    token into the result, so the backward reaches every exchange."""

    def __init__(self):
        self.token: Optional[torch.Tensor] = None

    def exchange(self, fwd, bwd, xs: Sequence[torch.Tensor]) -> list:
        if self.token is None:
            self.token = torch.zeros((), device=xs[0].device)
        self.token, *out = _Exchange.apply(fwd, bwd, self.token, *xs)
        return out

    def join(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` plus the token, an exact zero (``x`` unchanged, its
        gradient passed on unchanged)."""
        if self.token is None or not self.token.requires_grad:
            return x
        return x + self.token


def ppermute(tensors: Sequence[torch.Tensor], shift: Union[int, Sequence[int]], group, *,
             chain: Optional[Chain] = None) -> list:
    """The JAX package's ``lax.ppermute`` over the ring ``i -> (i + shift)
    % n`` of ``group``: each rank receives what rank ``(i - shift) % n``
    sent.  ``shift`` is one int, or one a tensor; all travel in one
    exchange.  Backward, the gradients rotate the opposite way.  The
    identity over a group of one (None)."""
    tensors = list(tensors)
    shifts = [shift] * len(tensors) if isinstance(shift, int) else list(shift)
    if group_size(group) == 1:
        return tensors
    back = [-s for s in shifts]
    return (chain or Chain()).exchange(lambda xs: _rotate(xs, shifts, group),
                                       lambda gs: _rotate(gs, back, group), tensors)


def all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int, group, *,
               chain: Optional[Chain] = None) -> torch.Tensor:
    """:func:`_relayout` with autograd: backward the inverse re-layout
    (split along ``concat_dim``, concatenate along ``split_dim``).  The
    identity over a group of one (None)."""
    if group_size(group) == 1:
        return x
    split_dim, concat_dim = split_dim % x.ndim, concat_dim % x.ndim
    (y,) = (chain or Chain()).exchange(
        lambda xs: [_relayout(xs[0], split_dim, concat_dim, group)],
        lambda gs: [_relayout(gs[0], concat_dim, split_dim, group)], [x])
    return y

