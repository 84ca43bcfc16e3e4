"""Workflow engine (port of ``znicz_tpu/workflow``): the layer-spec model
compiler and the host training loop around eager train/eval steps."""
