"""Multi-process bring-up: the control plane (port of
``znicz_tpu/parallel/multihost.py``).

Every process runs the same program, one device each; a TCP rendezvous at
the coordinator's address wires them into one default process group, and
the gradient exchange is a collective inside the train step
(``parallel/data_parallel.py``): no tensor moves over the control plane.

``initialize()`` with no arguments reads what ``torchrun`` sets
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``), as the JAX package autodetects a pod; off a launcher pass
``coordinator_address``, ``num_processes`` and ``process_id``.  The backend
is NCCL where a card is present (the process's card is ``LOCAL_RANK``'s,
default ``process_id`` modulo the cards) and gloo where there is none; a
caller who wants another backend makes the group itself, and everything
here takes whatever default group exists.  Every group has a timeout, so a
lost peer fails a collective instead of hanging it.

Unlike the JAX package, ``initialize`` sets up no logging: its
``core/logger.py::setup_logging`` is not ported yet (ROADMAP.md A11).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

# seconds a rendezvous or a collective may wait for its peers
TIMEOUT_S = 600.0


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> dict:
    """Join (or create) the multi-process job; returns its topology in the
    JAX package's keys.  Call before building a mesh: afterwards
    ``parallel.make_mesh()`` spans every process."""
    env = os.environ
    if coordinator_address is None:
        missing = [k for k in ("MASTER_ADDR", "MASTER_PORT") if k not in env]
        if missing:
            raise ValueError(
                "multihost.initialize() found no coordinator: pass "
                "coordinator_address, num_processes and process_id, or run "
                f"under torchrun (missing {', '.join(missing)})"
            )
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", 1))
    if process_id is None:
        process_id = int(env.get("RANK", 0))
    if torch.cuda.is_available():
        backend = "nccl"
        local = int(env.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    else:
        backend = "gloo"
    dist.init_process_group(
        backend,
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes),
        rank=int(process_id),
        timeout=datetime.timedelta(seconds=TIMEOUT_S),
    )
    return {
        "process_index": process_index(),
        "process_count": process_count(),
        "local_devices": 1,  # one device a process
        "global_devices": process_count(),
    }


def is_coordinator() -> bool:
    """True on exactly one process: it writes snapshots and runs the
    services (the reference's 'master does the bookkeeping' role)."""
    return process_index() == 0


def process_count() -> int:
    """Number of processes in the job (1 without a process group)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
