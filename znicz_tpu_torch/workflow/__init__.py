"""Workflow engine (port of ``znicz_tpu/workflow``): the layer-spec model
compiler and the host training loop around eager train/eval steps."""

from znicz_tpu_torch.workflow.unsupervised import (  # noqa: F401
    KohonenWorkflow,
    RBMWorkflow,
)
