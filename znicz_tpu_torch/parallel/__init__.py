"""Distribution layer: data parallelism over one process a device (port of
``znicz_tpu/parallel/``).

Replaces the reference's master/slave stack as the JAX package does: the
batch is split over the mesh's ``data`` axis, the parameters are
replicated, and the step sums the gradients with one all-reduce, so every
rank trains on its shard of one consistent model, synchronously.  In the
JAX package one process drives every device of a mesh; here each process
drives one device, a rank is a position on the data axis, and
``multihost.initialize`` (or ``torchrun``) makes the process group.
Failure recovery is checkpoint-based restart through the snapshotter.

Not ported yet: tensor and expert parallelism (ROADMAP.md A6), ring
attention and the pipeline (A7).
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
