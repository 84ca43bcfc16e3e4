"""Training layer (port of ``znicz_tpu/nn``): the optimizer's update rule,
evaluators, decision, lr schedules and the train state."""

from znicz_tpu_torch.nn import decision  # noqa: F401
from znicz_tpu_torch.nn import evaluator  # noqa: F401
from znicz_tpu_torch.nn import lr_adjust  # noqa: F401
from znicz_tpu_torch.nn import optimizer  # noqa: F401
from znicz_tpu_torch.nn.train_state import TrainState  # noqa: F401
