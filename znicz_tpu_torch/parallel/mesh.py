"""Mesh construction and placement helpers (port of
``znicz_tpu/parallel/mesh.py``).

One process runs one device, so a rank is both a process and a position
on the mesh's ``data`` axis: a world of R ranks is the counterpart of the
JAX package's ``make_mesh(R, 1)``, and every rank serves its contiguous
``1/R`` of each global minibatch.  The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the default
process group, with the JAX package's axis names; it creates no process
group of its own (the data axis spans the whole default group, the
``model`` axis is 1).  With no process group it is a mesh of this one
process.

The ``model`` and ``pipe`` axes shard weights, which nothing ported yet
does: ``n_model > 1`` and ``n_pipe > 1`` are refused by name.
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
):
    """A ``(data, model)`` ``DeviceMesh`` over the given ranks (default:
    every rank of the default process group, in rank order).

    ``n_data=None`` puts every remaining rank on the data axis.  More
    ranks than the world holds raise the JAX package's "needs N devices,
    have M": the JAX package's single-process many-device meshes have no
    counterpart here, where one process runs one device."""
    from torch.distributed.device_mesh import DeviceMesh

    from znicz_tpu_torch.workflow.workflow import refuse_unported

    refuse_unported((
        (n_model > 1, "tensor parallelism (a model axis > 1)", "A6, cnn_tp_rules"),
        (n_pipe > 1, "pipeline parallelism (a pipe axis > 1)", "A7, parallel/pipeline.py"),
    ))
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
    grid = torch.tensor(ranks[:need], dtype=torch.int).reshape(n_data, n_model)
    # the mesh names the ranks; collectives run over the default group
    # (parallel/data_parallel.py), so it builds no sub-group
    return DeviceMesh(device_type(), grid, mesh_dim_names=(DATA_AXIS, MODEL_AXIS),
                      _init_backend=False, _rank=rank)


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


def mesh_from_spec(spec: str, *, devices: Optional[Sequence[int]] = None):
    """``"data=4,model=2"`` -> mesh (unlisted axes default to 1; ``data``
    with no explicit size takes the remaining ranks)."""
    sizes = parse_mesh_spec(spec)
    return make_mesh(
        sizes.get(DATA_AXIS),
        sizes.get(MODEL_AXIS, 1),
        sizes.get(PIPE_AXIS, 1),
        devices=devices,
    )


def axis_size(mesh, name: str) -> int:
    """The size of ``mesh``'s axis ``name`` (1 when it has no such axis)."""
    names = list(mesh.mesh_dim_names or ())
    return int(mesh.mesh.shape[names.index(name)]) if name in names else 1


def verify_process_contiguous_data_axis(mesh) -> None:
    """Check the row-ownership contract: each process's ranks occupy one
    contiguous, process-pure block of the ``data`` axis, in process order,
    with equal shares.  ``Loader.set_process_shard`` serves process ``p``
    rows ``[p*B/P, (p+1)*B/P)`` of every global minibatch, so a mesh whose
    rank order interleaves processes would hand each process's rows other
    global positions than the loader contract states.  Here a process is a
    rank; ``make_mesh`` orders them, so this only trips hand-built
    meshes."""
    axes = list(mesh.mesh_dim_names or ())
    if DATA_AXIS not in axes:
        return
    dev = np.moveaxis(mesh.mesh.numpy(), axes.index(DATA_AXIS), 0)
    dev = dev.reshape(dev.shape[0], -1)  # 1-D (data-only) meshes included
    rows = [sorted({int(r) for r in row}) for row in dev]
    procs = [r[0] for r in rows]
    counts = [procs.count(p) for p in sorted(set(procs))]
    if (
        any(len(r) != 1 for r in rows)
        or procs != sorted(procs)
        # the loader serves EQUAL 1/P row blocks
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
