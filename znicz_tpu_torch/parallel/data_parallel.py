"""Data (+ optional tensor) parallel placement policy and collectives for
workflows (port of ``znicz_tpu/parallel/data_parallel.py``).

One process runs one device.  Each rank of data row ``d`` trains on the
row's contiguous ``1/D`` of every global minibatch (the loader's process
shard), and the step sums the gradients with one all-reduce over the data
axis: the torch counterpart of the all-reduce XLA inserts into the JAX
package's jitted step.  The loss's denominator is the global count of
valid rows, so the summed gradient is the global batch's, equal to one
process's.  Synchronous by construction, as in the JAX package.

Tensor parallelism (``tp=True``, absent in the reference): a leaf whose
placement spec names the ``model`` axis lives on rank ``(d, m)`` as its
``m``-th contiguous block along that dim (params and velocity alike);
every other leaf is whole on every rank.  The placement is the JAX
package's: ``param_rules`` first (:func:`cnn_tp_rules` for conv models,
``lm_tp_rules`` for the LM), then the size heuristic (a leaf whose last
dim is at least ``tp_min_features`` and divides the model axis is
column-sharded).  Where GSPMD propagates shardings and inserts the
collectives for the JAX package, the port's forwards call Megatron's
conjugate operators themselves (``parallel/tensor_parallel.py``).
:meth:`DataParallel.gather_state` rebuilds whole tensors (snapshots,
decoding).

The collectives run over this rank's data column (:func:`data_group`)
and model row (:func:`model_group`): the default process group when the
model axis is 1, else the mesh's per-axis groups.  With no group
(one process) they are the identity; a group of one rank still runs them,
so a one-rank NCCL group exercises the production path.  NCCL collectives
are captured into the scan dispatch's CUDA graphs; gloo's stage a card's
tensors through the host inside the call, which no graph can capture
(``host_collectives``).

Random draws per sample (dropout's masks, stochastic pooling's noise) are
drawn for the global batch and the rank takes its rows
(:func:`batch_rand`), so R ranks draw what one process draws, and model
peers, which hold the same rows and the same generator, draw alike.
"""

from __future__ import annotations

import contextlib
import re
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from znicz_tpu_torch.parallel import multihost
from znicz_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    axis_size,
    make_mesh,
    verify_process_contiguous_data_axis,
    world,
)
from znicz_tpu_torch.parallel.tensor_parallel import P, all_gather, local_slice, spec_dims

# (this rank's position, ranks) on the data axis while a train step runs
_BATCH_SHARD = (0, 1)


def cnn_tp_rules(model, n_model: int, *, tp_min_features: int = 1024):
    """Channel-aware tensor-parallel placement for conv/FC models.

    Megatron-style alternation over the model's weighted layers: a layer
    whose output channels/features divide the ``model`` axis is COLUMN
    sharded (conv ``[ky, kx, in, out]`` on ``out``, FC ``[in, out]`` on
    ``out``, bias along); the NEXT weighted layer is ROW sharded on its
    input dim, so each rank contracts its block and the partial products
    are summed.  FC layers additionally honor ``tp_min_features`` (the
    size heuristic's threshold) so small heads stay whole; conv layers
    shard on divisibility alone.  Returns a ``param_rules`` callable for
    :class:`DataParallel`, over the JAX package's ``keystr`` paths
    (``"[1]['weights']"``).
    """
    specs = {}
    col_prev = False
    for i, params in enumerate(model.params):
        w = params.get("weights") if isinstance(params, dict) else None
        if w is None or w.ndim < 2:
            continue
        is_conv = w.ndim == 4
        out_dim = w.shape[-1]
        in_dim = w.shape[-2] if is_conv else w.shape[0]
        if col_prev and is_conv and in_dim % n_model == 0:
            # row-parallel follower: shard the input/contraction dim.
            # Conv only: an FC after a flatten sees the channel-sharded
            # activations INTERLEAVED through its h*w*c input dim
            # (channel-minor flatten), so a contiguous dim-0 block would
            # not be the rank's channels
            specs[(i, "weights")] = P(None, None, MODEL_AXIS, None)
            specs[(i, "bias")] = P()
            col_prev = False
        elif out_dim % n_model == 0 and (is_conv or out_dim >= tp_min_features):
            specs[(i, "weights")] = P(*([None] * (w.ndim - 1)), MODEL_AXIS)
            specs[(i, "bias")] = P(MODEL_AXIS)
            col_prev = True
        else:
            col_prev = False

    pat = re.compile(r"\[(\d+)\]\['(\w+)'\]")

    def rules(path: str, leaf):
        m = pat.search(path)
        if not m:
            return P()
        return specs.get((int(m.group(1)), m.group(2)), P())

    return rules


def _check_world(mesh) -> bool:
    """Whether a process group exists; the mesh must then span every
    process (one process a device)."""
    _, size = world()
    n = int(mesh.mesh.numel())
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(f"a mesh of {n} ranks needs a process group of {n} ranks; "
                             "call multihost.initialize first")
        return False
    if n != size:
        raise ValueError(
            f"the mesh holds {n} ranks but the process group {size}: the mesh "
            "must span every process (one process a device)"
        )
    return True


def axis_group(mesh, name: str):
    """The process group of this rank's peers on the mesh's axis ``name``:
    None without a process group; the default group where the axis spans
    every rank in rank order (a mesh that makes no sub-groups; a group of
    one rank still runs its collectives, so a one-rank NCCL group
    exercises the production path); None for another axis of 1 (every
    collective over it is the identity); else the mesh's group of that
    axis."""
    if not _check_world(mesh):
        return None
    ranks = mesh.mesh.flatten().tolist()
    if axis_size(mesh, name) == len(ranks) and ranks == sorted(ranks):
        return dist.group.WORLD
    return None if axis_size(mesh, name) == 1 else mesh.get_group(name)


def data_group(mesh):
    """The process group this rank's data column reduces over (its data
    peers: the ranks that hold the same model block and pipeline stage)."""
    return axis_group(mesh, DATA_AXIS)


def model_group(mesh):
    """The process group of this rank's model row (its model peers, which
    hold the other blocks of every sharded leaf); None for a model axis of
    1."""
    return None if axis_size(mesh, MODEL_AXIS) == 1 else axis_group(mesh, MODEL_AXIS)


def pipe_group(mesh):
    """The process group of this rank's pipeline (its pipe peers, which
    hold the other stages); None for a pipe axis of 1."""
    return None if axis_size(mesh, PIPE_AXIS) == 1 else axis_group(mesh, PIPE_AXIS)


def axis_index(mesh, name: str) -> int:
    """This process's position on the mesh's axis ``name`` (0 where the
    mesh has no such axis)."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this process is not on the mesh")
    names = list(mesh.mesh_dim_names)
    return int(coord[names.index(name)]) if name in names else 0


def data_index(mesh) -> int:
    """This process's position on the mesh's data axis."""
    return axis_index(mesh, DATA_AXIS)


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
    and the collectives over the data, model and pipe axes.

    ``mesh``: a :func:`make_mesh` mesh (default: every rank of the default
    group on the data axis).  ``tp``: shard weights over the ``model``
    axis (on when the axis is above 1).  ``param_rules``: a callable
    ``(path, leaf) -> spec or None`` (a :class:`~znicz_tpu_torch.parallel.
    tensor_parallel.PartitionSpec`), asked first for every leaf; None
    falls through to the size heuristic (``tp_min_features``)."""

    def __init__(
        self,
        mesh=None,
        *,
        tp: bool = False,
        tp_min_features: int = 1024,
        param_rules=None,
    ):
        self.mesh = mesh if mesh is not None else make_mesh()
        if multihost.process_count() > 1:
            # the loader's per-rank row contract only holds when each data
            # row's ranks are one contiguous block
            verify_process_contiguous_data_axis(self.mesh)
        self.group = data_group(self.mesh)
        self.model_group = model_group(self.mesh)
        self.pipe_group = pipe_group(self.mesh)
        self.tp = tp and self.n_model > 1
        self.tp_min_features = tp_min_features
        self.param_rules = param_rules
        # path -> sharded dim of every model-sharded leaf, and of every
        # leaf sharded over the pipe axis (a stacked stage leaf), as
        # shard_state placed them
        self.sharded: Dict[str, int] = {}
        self.staged: Dict[str, int] = {}

    @property
    def n_data(self) -> int:
        return axis_size(self.mesh, DATA_AXIS)

    @property
    def n_model(self) -> int:
        return axis_size(self.mesh, MODEL_AXIS)

    @property
    def index(self) -> int:
        """This rank's position on the data axis."""
        return data_index(self.mesh)

    @property
    def n_pipe(self) -> int:
        return axis_size(self.mesh, PIPE_AXIS)

    @property
    def model_index(self) -> int:
        """This rank's position on the model axis: the block of every
        sharded leaf it holds."""
        return axis_index(self.mesh, MODEL_AXIS)

    @property
    def pipe_index(self) -> int:
        """This rank's position on the pipe axis: its pipeline stage."""
        return axis_index(self.mesh, PIPE_AXIS)

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
        return (dist.is_initialized() and self.mesh.device_type == "cuda"
                and dist.get_backend() != "nccl")

    # -- batches -----------------------------------------------------------
    def shard_batch(self, arr, *, batch_dim: int = 0) -> torch.Tensor:
        """This rank's rows of a global batch on its device.  ``arr`` is
        the rank's slice, as the loader's process shard serves it (rows
        ``[d*B/D, (d+1)*B/D)`` for data row ``d``); in one process the
        batch must divide by the data axis.  ``batch_dim=1`` serves
        epoch-stacked ``[n_steps, B, ...]`` payloads."""
        arr = arr if isinstance(arr, torch.Tensor) else np.asarray(arr)
        if multihost.process_count() == 1 and arr.shape[batch_dim] % self.n_data:
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
    def _param_spec(self, path: str, leaf):
        if self.param_rules is not None:
            spec = self.param_rules(path, leaf)
            if spec is not None:
                return spec
        if (
            self.tp
            and hasattr(leaf, "ndim")
            and leaf.ndim >= 1
            and leaf.shape[-1] >= self.tp_min_features
            and leaf.shape[-1] % self.n_model == 0
        ):
            # shard the output-features dim: column-parallel FC / conv
            return P(*([None] * (leaf.ndim - 1)), MODEL_AXIS)
        return P()

    def placements(self, tree) -> Dict[str, Dict[str, int]]:
        """``{path: {axis: dim}}`` of a tree of whole leaves: the dims
        each leaf shards over the ``model`` and ``pipe`` axes (an axis of 1
        shards nothing), the paths the JAX package's ``keystr``
        (``"[1]['wq']"``, ``"['stages'][0]['wq']"``)."""
        sizes = {MODEL_AXIS: self.n_model, PIPE_AXIS: self.n_pipe}
        out: Dict[str, Dict[str, int]] = {}
        for path, leaf in _leaves(tree):
            dims = {a: d for a, d in spec_dims(self._param_spec(path, leaf)).items()
                    if sizes[a] > 1}
            for axis, dim in dims.items():
                if leaf.shape[dim] % sizes[axis]:
                    raise ValueError(
                        f"{path}: dim {dim} of shape {tuple(leaf.shape)} does not divide by "
                        f"the {axis} axis {sizes[axis]}"
                    )
            out[path] = dims
        return out

    def specs(self, tree) -> Dict[str, Optional[int]]:
        """``{path: dim sharded over the model axis, or None}`` of a tree
        of whole leaves (:meth:`placements`)."""
        return {p: d.get(MODEL_AXIS) for p, d in self.placements(tree).items()}

    def _groups(self):
        return {MODEL_AXIS: self.model_group, PIPE_AXIS: self.pipe_group}

    def shard_state(self, state):
        """The train state's params and velocity on this rank's device, a
        sharded leaf as this rank's block (its pipeline stage, then its
        model block), from a state of whole leaves (identical seeds give
        every rank identical values).  The placement is decided from the
        params and kept (:attr:`sharded`, :attr:`staged`); a velocity leaf
        shards as the param at its path."""
        places = self.placements(state.params)
        self.sharded = {p: d[MODEL_AXIS] for p, d in places.items() if MODEL_AXIS in d}
        self.staged = {p: d[PIPE_AXIS] for p, d in places.items() if PIPE_AXIS in d}
        groups = self._groups()

        def put(path, leaf):
            grad = leaf.requires_grad
            dims = places.get(path, {})
            if not dims and leaf.device == self.device:
                return leaf
            leaf = leaf.detach()
            for axis in (PIPE_AXIS, MODEL_AXIS):
                if axis in dims:
                    leaf = local_slice(leaf, dims[axis], groups[axis])
            return leaf.to(self.device).clone().requires_grad_(grad)

        state.params = _map(put, state.params)
        state.velocity = _map(put, state.velocity)
        return state

    def gather_state(self, tree):
        """A tree of this rank's leaves with every sharded leaf made whole
        (all-gathers over the model group, then over the pipe group; every
        rank of the mesh takes part); whole leaves are returned as they
        are."""
        if not (self.sharded or self.staged):
            return tree

        def whole(path, leaf):
            if path in self.sharded:
                leaf = all_gather(leaf.detach(), self.sharded[path], self.model_group)
            if path in self.staged:
                leaf = all_gather(leaf.detach(), self.staged[path], self.pipe_group)
            return leaf

        return _map(whole, tree)

    # -- collectives ---------------------------------------------------------
    def all_reduce(self, tensors: Sequence[torch.Tensor], op: str = "sum") -> List[torch.Tensor]:
        return all_reduce(tensors, self.mesh, op)


def _leaves(tree, prefix: str = ""):
    """``(keystr path, leaf)`` pairs of a tree of lists and dicts, in the
    JAX package's ``tree_leaves_with_path`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _map(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over a tree of lists and dicts, the containers
    kept (a tuple becomes a list)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, f"{prefix}[{k!r}]") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v, f"{prefix}[{i}]") for i, v in enumerate(tree)]
    return fn(prefix, tree)
