"""Data-parallel placement policy and collectives for workflows (port of
``znicz_tpu/parallel/data_parallel.py``).

One process runs one device and holds a full replica of the train state;
each rank trains on its contiguous ``1/R`` of every global minibatch (the
loader's process shard), and the step sums the ranks' gradients with one
all-reduce over the data axis: the torch counterpart of the all-reduce XLA
inserts into the JAX package's jitted step.  The loss's denominator is
the global count of valid rows, so the summed gradient is the global
batch's, equal to one process's.  Synchronous by construction, as in the
JAX package.

The collectives run over the default process group.  With no group (one
process) they are the identity; a group of one rank still runs them, so
a one-rank NCCL group exercises the production path.  NCCL collectives
are captured into the scan dispatch's CUDA graphs; gloo's stage a card's
tensors through the host inside the call, which no graph can capture
(``host_collectives``).

Random draws per sample (dropout's masks, stochastic pooling's noise) are
drawn for the global batch and the rank takes its rows
(:func:`batch_rand`), so R ranks draw what one process draws.

Tensor parallelism (``tp=True``, ``param_rules``, :func:`cnn_tp_rules`) is
not ported yet and is refused by name (ROADMAP.md A6).
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from znicz_tpu_torch.parallel import multihost
from znicz_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    axis_size,
    make_mesh,
    verify_process_contiguous_data_axis,
    world,
)

_TP = "A6, cnn_tp_rules"

# (this rank's position, ranks) on the data axis while a train step runs
_BATCH_SHARD = (0, 1)


def cnn_tp_rules(model, n_model: int, *, tp_min_features: int = 1024):
    """Tensor-parallel placement rules for conv/FC models: not ported."""
    from znicz_tpu_torch.workflow.workflow import refuse_unported

    refuse_unported(((True, "cnn_tp_rules (tensor parallelism)", _TP),))


def data_group(mesh):
    """The process group the mesh's data axis reduces over: the default
    group, which the axis must span; None without a group (one process:
    every collective is the identity)."""
    _, size = world()
    n = axis_size(mesh, DATA_AXIS) * axis_size(mesh, MODEL_AXIS)
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(f"a data axis of {n} needs a process group of {n} ranks; "
                             "call multihost.initialize first")
        return None
    if n != size:
        raise ValueError(
            f"the mesh holds {n} ranks but the process group {size}: the data "
            "axis must span every process (one process a device)"
        )
    return dist.group.WORLD


def data_index(mesh) -> int:
    """This process's position on the mesh's data axis."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this process is not on the mesh")
    return int(coord[list(mesh.mesh_dim_names).index(DATA_AXIS)])


def all_reduce(tensors: Sequence[torch.Tensor], mesh, op: str = "sum") -> List[torch.Tensor]:
    """``tensors`` reduced over the mesh's data axis (``op`` "sum" or
    "max"), as new tensors of the same shapes: those of one dtype travel
    flattened into one buffer, one collective each.  The identity without
    a process group."""
    group = data_group(mesh)
    if group is None:
        return list(tensors)
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        buf = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        dist.all_reduce(buf, op=getattr(dist.ReduceOp, op.upper()), group=group)
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = buf[off:off + n].view(tensors[i].shape)
            off += n
    return out


def psum(tensors: Sequence[torch.Tensor], mesh, axis: str = DATA_AXIS) -> List[torch.Tensor]:
    """The JAX package's ``lax.psum`` over the mesh's batch axis, for the
    kernels' partitioning rules: :func:`all_reduce` (sum)."""
    if axis != DATA_AXIS:
        raise ValueError(f"data_axis={axis!r}: the mesh's batch axis is {DATA_AXIS!r}")
    return all_reduce(tensors, mesh)


@contextlib.contextmanager
def batch_shard(index: int, count: int):
    """Within the block, :func:`batch_rand` draws for ``count`` ranks' rows
    and returns rank ``index``'s."""
    global _BATCH_SHARD
    prev, _BATCH_SHARD = _BATCH_SHARD, (int(index), int(count))
    try:
        yield
    finally:
        _BATCH_SHARD = prev


def batch_rand(shape, *, generator, device, dtype=None) -> torch.Tensor:
    """``torch.rand(shape)`` whose dim 0 is this rank's rows of a batch
    ``count`` times larger, drawn whole from ``generator`` (outside a
    :func:`batch_shard` block: the plain draw)."""
    index, count = _BATCH_SHARD
    shape = tuple(shape)
    if count == 1:
        return torch.rand(shape, generator=generator, device=device, dtype=dtype)
    u = torch.rand((shape[0] * count,) + shape[1:], generator=generator, device=device,
                   dtype=dtype)
    return u[index * shape[0]:(index + 1) * shape[0]]


class DataParallel:
    """Placement policy: how batches and params land on the rank's device,
    and the collectives over the data axis.

    ``mesh``: a :func:`make_mesh` mesh (default: every rank of the default
    group).  ``tp``, ``tp_min_features`` and ``param_rules`` are the JAX
    package's tensor-parallel knobs: taken at their defaults, refused
    otherwise."""

    def __init__(
        self,
        mesh=None,
        *,
        tp: bool = False,
        tp_min_features: int = 1024,
        param_rules=None,
    ):
        from znicz_tpu_torch.workflow.workflow import refuse_unported

        refuse_unported((
            (tp, "tensor parallelism (tp=True)", _TP),
            (param_rules is not None, "param_rules (tensor-parallel placement)", _TP),
        ))
        self.mesh = mesh if mesh is not None else make_mesh()
        if multihost.process_count() > 1:
            # the loader's per-process row contract only holds when each
            # process owns one contiguous block of the data axis
            verify_process_contiguous_data_axis(self.mesh)
        self.group = data_group(self.mesh)
        self.tp = False
        self.tp_min_features = tp_min_features
        self.param_rules = None

    @property
    def n_data(self) -> int:
        return axis_size(self.mesh, DATA_AXIS)

    @property
    def index(self) -> int:
        """This rank's position on the data axis."""
        return data_index(self.mesh)

    @property
    def device(self) -> torch.device:
        """This rank's device: its current card, or the CPU."""
        if self.mesh.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")

    @property
    def host_collectives(self) -> bool:
        """True where a collective stages a card's tensors through the host
        (a gloo group on the card): nothing in it can be captured into a
        CUDA graph."""
        return (self.group is not None and self.mesh.device_type == "cuda"
                and dist.get_backend() != "nccl")

    # -- batches -----------------------------------------------------------
    def shard_batch(self, arr, *, batch_dim: int = 0) -> torch.Tensor:
        """This rank's rows of a global batch on its device.  ``arr`` is
        the rank's slice, as the loader's process shard serves it (rows
        ``[p*B/P, (p+1)*B/P)``); the global batch must divide by the data
        axis.  ``batch_dim=1`` serves epoch-stacked ``[n_steps, B, ...]``
        payloads."""
        arr = arr if isinstance(arr, torch.Tensor) else np.asarray(arr)
        nproc = multihost.process_count()
        if nproc > 1:
            n = arr.shape[batch_dim] * nproc
            if n % self.n_data:
                raise ValueError(f"global batch {n} not divisible by data axis {self.n_data}")
        elif arr.shape[batch_dim] % self.n_data:
            raise ValueError(
                f"batch {arr.shape[batch_dim]} not divisible by data axis "
                f"{self.n_data}; choose minibatch_size as a multiple"
            )
        return torch.as_tensor(arr, device=self.device)

    def put_replicated(self, arr) -> torch.Tensor:
        """Data identical on every process (loader device contexts) on
        this rank's device."""
        return torch.as_tensor(np.asarray(arr) if not isinstance(arr, torch.Tensor) else arr,
                               device=self.device)

    # -- params ------------------------------------------------------------
    def shard_state(self, state):
        """The train state's params and velocity on this rank's device
        (every rank holds a full replica; identical seeds give identical
        values); a tensor already there is kept as it is."""
        def put(tree):
            if isinstance(tree, dict):
                return {k: put(v) for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return [put(v) for v in tree]
            if tree.device == self.device:
                return tree
            return tree.detach().to(self.device).requires_grad_(tree.requires_grad)

        state.params = put(state.params)
        state.velocity = put(state.velocity)
        return state

    # -- collectives ---------------------------------------------------------
    def all_reduce(self, tensors: Sequence[torch.Tensor], op: str = "sum") -> List[torch.Tensor]:
        return all_reduce(tensors, self.mesh, op)
