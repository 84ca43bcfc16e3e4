"""Mesh construction and placement helpers (port of
``znicz_tpu/parallel/mesh.py``).

One process runs one device, so a rank is both a process and one point
``(d, m, p)`` of the ``(data, model, pipe)`` mesh: rank ``(d * n_model +
m) * n_pipe + p``, the JAX package's ``reshape(n_data, n_model, n_pipe)``
order, so a data row's model and pipe peers are adjacent ranks.  Every
rank of data row ``d`` serves that row's contiguous ``1/n_data`` of each
global minibatch; the model axis shards weights
(``parallel/tensor_parallel.py``) and the pipe axis holds pipeline stages
(``parallel/pipeline.py``).  The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the default
process group, with the JAX package's axis names: ``(data, model)``, and
``(data, model, pipe)`` only with a pipe axis above 1, as the JAX
package's.  With a model or pipe axis above 1 the mesh makes its per-axis
process groups (``mesh.get_group(name)``; every rank makes them alike);
otherwise it makes none and the data axis reduces over the default group.
With no process group it is a mesh of this one process.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"


def world() -> tuple:
    """``(rank, world size)`` of the default process group; ``(0, 1)``
    without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def device_type() -> str:
    """``"cuda"`` where this process's device is the card, else ``"cpu"``."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_mesh(
    n_data: Optional[int] = None,
    n_model: int = 1,
    n_pipe: int = 1,
    *,
    devices: Optional[Sequence[int]] = None,
    device: Optional[str] = None,
):
    """A ``(data, model)`` ``DeviceMesh`` over the given ranks (default:
    every rank of the default process group, in rank order), ``(data,
    model, pipe)`` with ``n_pipe > 1``, placing on ``device`` (``"cuda"``
    or ``"cpu"``; default :func:`device_type`): build it on the device
    the workflow runs on.

    ``n_data=None`` puts every remaining rank on the data axis.  More
    ranks than the world holds raise the JAX package's "needs N devices,
    have M": the JAX package's single-process many-device meshes have no
    counterpart here, where one process runs one device.  With
    ``n_model > 1`` or ``n_pipe > 1`` every rank of the default group must
    call this alike: the mesh makes its per-axis process groups."""
    from torch.distributed.device_mesh import DeviceMesh

    rank, size = world()
    ranks = list(devices) if devices is not None else list(range(size))
    if n_data is None:
        n_data = len(ranks) // (n_model * n_pipe)
    need = n_data * n_model * n_pipe
    if need > len(ranks) or need < 1:
        raise ValueError(
            f"mesh {n_data}x{n_model}x{n_pipe} needs {need} devices, "
            f"have {len(ranks)}"
        )
    grid = torch.tensor(ranks[:need], dtype=torch.int)
    if n_pipe > 1:
        grid, names = grid.reshape(n_data, n_model, n_pipe), (DATA_AXIS, MODEL_AXIS, PIPE_AXIS)
    else:
        grid, names = grid.reshape(n_data, n_model), (DATA_AXIS, MODEL_AXIS)
    # a data-only mesh reduces over the default group: no sub-group
    return DeviceMesh(device or device_type(), grid, mesh_dim_names=names,
                      _init_backend=n_model * n_pipe > 1, _rank=rank)


def parse_mesh_spec(spec: str) -> dict:
    """Parse the CLI/config mesh syntax ``"data=4,model=2,pipe=1"``;
    returns axis -> size."""
    sizes = {}
    for part in spec.replace(" ", "").split(","):
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"bad mesh spec entry {part!r}: want axis=size "
                "(e.g. data=4,model=2)"
            )
        name, _, val = part.partition("=")
        if name not in (DATA_AXIS, MODEL_AXIS, PIPE_AXIS):
            raise ValueError(
                f"unknown mesh axis {name!r}: valid axes are "
                f"{DATA_AXIS}/{MODEL_AXIS}/{PIPE_AXIS}"
            )
        sizes[name] = int(val)
        if sizes[name] < 1:
            raise ValueError(f"mesh axis {name} must be >= 1")
    return sizes


def mesh_from_spec(spec: str, *, devices: Optional[Sequence[int]] = None,
                   device: Optional[str] = None):
    """``"data=4,model=2"`` -> mesh (unlisted axes default to 1; ``data``
    with no explicit size takes the remaining ranks), placing on
    ``device`` as :func:`make_mesh` does."""
    sizes = parse_mesh_spec(spec)
    return make_mesh(
        sizes.get(DATA_AXIS),
        sizes.get(MODEL_AXIS, 1),
        sizes.get(PIPE_AXIS, 1),
        devices=devices,
        device=device,
    )


def axis_size(mesh, name: str) -> int:
    """The size of ``mesh``'s axis ``name`` (1 when it has no such axis)."""
    names = list(mesh.mesh_dim_names or ())
    return int(mesh.mesh.shape[names.index(name)]) if name in names else 1


def verify_process_contiguous_data_axis(mesh) -> None:
    """Check the row-ownership contract: each data row's ranks are one
    contiguous block of ranks, the rows in rank order, with equal shares.
    ``Loader.set_process_shard`` serves every rank of data row ``d`` rows
    ``[d*B/D, (d+1)*B/D)`` of every global minibatch (its model peers
    serve the same rows), so a mesh whose rank order interleaves the data
    rows would hand each rank's rows other global positions than the
    loader contract states.  Here a process is a rank; ``make_mesh``
    orders them, so this only trips hand-built meshes."""
    axes = list(mesh.mesh_dim_names or ())
    if DATA_AXIS not in axes:
        return
    dev = np.moveaxis(mesh.mesh.numpy(), axes.index(DATA_AXIS), 0)
    dev = dev.reshape(dev.shape[0], -1)  # 1-D (data-only) meshes included
    rows = [sorted({int(r) for r in row}) for row in dev]
    procs = [r[0] for r in rows]
    counts = [len(r) for r in rows]
    if (
        any(r != list(range(r[0], r[0] + len(r))) for r in rows)
        or procs != sorted(procs)
        # the loader serves EQUAL 1/D row blocks
        or len(set(counts)) > 1
    ):
        raise ValueError(
            "multi-host data axis does not give each process one equal "
            f"contiguous block: data-axis rows map to processes {rows}; "
            "order the mesh devices so every process owns "
            "n_data/n_processes consecutive rows (make_mesh's rank "
            "order does this)"
        )


def data_sharding(mesh, ndim: int) -> tuple:
    """Dim 0 (the batch) sharded over ``data``, the rest replicated: the
    DTensor placements, one a mesh axis."""
    from torch.distributed.tensor import Replicate, Shard

    if ndim < 1:
        raise ValueError(f"data_sharding needs a batch dim, got ndim {ndim}")
    names = list(mesh.mesh_dim_names)
    return tuple(Shard(0) if n == DATA_AXIS else Replicate() for n in names)


def replicated(mesh) -> tuple:
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def batch_divisible(batch: int, mesh) -> bool:
    return batch % axis_size(mesh, DATA_AXIS) == 0
