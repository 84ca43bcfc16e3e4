"""UCI Wine MLP (port of ``znicz_tpu/models/wine.py``), the reference's
smallest end-to-end sample.

All2AllTanh(10) -> softmax(3), lr 0.3, momentum 0.5, batch 10, on one
``train`` split (178 samples, "mean_disp" normalized): the ``wine.data``
CSV at ``data_path`` when given, else the synthetic stand-in drawn as the
JAX package draws it.
"""

from znicz_tpu_torch.core import device as device_lib
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.loader import datasets
from znicz_tpu_torch.models import effective_config, merge_workflow_kwargs
from znicz_tpu_torch.workflow.standard import StandardWorkflow

_GD = {"learning_rate": 0.3, "gradient_moment": 0.5}

DEFAULTS = {
    "loader": {"data_path": None, "minibatch_size": 10},
    "layers": [
        {"type": "all2all_tanh", "->": {"output_sample_shape": 10}, "<-": _GD},
        {"type": "softmax", "->": {"output_sample_shape": 3}, "<-": _GD},
    ],
    "decision": {"max_epochs": 100, "fail_iterations": 50},
}
root.wine.update(DEFAULTS)


def build_workflow(**overrides) -> StandardWorkflow:
    """The Wine workflow; ``device=`` picks the device (default: the card,
    raising without one), other overrides go to StandardWorkflow."""
    overrides["device"] = device_lib.resolve(overrides.get("device"))
    cfg = effective_config(root.wine, DEFAULTS)
    loader = datasets.wine(
        cfg.loader.get("data_path"),
        minibatch_size=cfg.loader.get("minibatch_size", 10),
    )
    kwargs = merge_workflow_kwargs(
        {"decision_config": cfg.decision.to_dict(), "name": "WineWorkflow"},
        overrides,
    )
    return StandardWorkflow(loader, cfg.get("layers"), **kwargs)


def run(load, main):
    load(build_workflow)
    main()
