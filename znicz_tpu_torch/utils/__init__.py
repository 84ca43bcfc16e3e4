"""Host utilities: fault injection and profiling helpers."""

from znicz_tpu_torch.utils.profiling import (  # noqa: F401
    StepTimer,
    trace,
)
