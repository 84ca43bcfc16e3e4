"""Training layer (port of ``znicz_tpu/nn``): the optimizer's update rule,
evaluators, decision, lr schedules and the train state."""
