"""Distribution layer: data, tensor, expert, sequence and pipeline
parallelism over one process a device (port of ``znicz_tpu/parallel/``).

Replaces the reference's master/slave stack as the JAX package does: the
batch is split over the mesh's ``data`` axis and the step sums the
gradients with one all-reduce, so every rank trains on its shard of one
consistent model, synchronously; the ``model`` axis shards weights
(Megatron tensor parallelism, the MoE's experts,
``parallel/tensor_parallel.py``); ring attention splits the sequence over
an axis (``parallel/ring_attention.py``) and the ``pipe`` axis holds
pipeline stages (``parallel/pipeline.py``).  In the JAX package one process
drives every device of a mesh; here each process drives one device, a rank
is a point of the ``(data, model[, pipe])`` mesh, and
``multihost.initialize`` (or ``torchrun``) makes the process group.
Failure recovery is checkpoint-based restart through the snapshotter.
"""

from znicz_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    data_sharding,
    make_mesh,
    mesh_from_spec,
    parse_mesh_spec,
    replicated,
)
from znicz_tpu_torch.parallel.data_parallel import DataParallel  # noqa: F401
