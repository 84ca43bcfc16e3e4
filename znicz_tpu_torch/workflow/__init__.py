"""Workflow engine (port of ``znicz_tpu/workflow``): the layer-spec model
compiler, the host training loop around eager train/eval steps, and the
topology introspection (``model_summary``, ``to_dot``).
"""

from znicz_tpu_torch.workflow.model import Model, build  # noqa: F401
from znicz_tpu_torch.workflow.recovery import (  # noqa: F401
    EXIT_PREEMPTED,
    RecoveryPolicy,
    RollbackExhaustedError,
    TrainingPreempted,
)
from znicz_tpu_torch.workflow.snapshotter import (  # noqa: F401
    SnapshotCorruptError,
    Snapshotter,
    SnapshotWriteError,
    find_latest_valid,
    load_snapshot,
)
from znicz_tpu_torch.workflow.workflow import Workflow  # noqa: F401
from znicz_tpu_torch.workflow.standard import StandardWorkflow  # noqa: F401
from znicz_tpu_torch.workflow.unsupervised import (  # noqa: F401
    KohonenWorkflow,
    RBMWorkflow,
)
from znicz_tpu_torch.workflow.transformer import (  # noqa: F401
    TransformerLMWorkflow,
)
from znicz_tpu_torch.workflow.introspect import model_summary, to_dot  # noqa: F401
