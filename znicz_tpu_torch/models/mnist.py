"""MNIST fully-connected MLP (port of ``znicz_tpu/models/mnist.py``;
BASELINE.json configs[0]).

All2AllTanh(100) -> softmax(10) with momentum 0.9, weight decay 5e-4 and lr
0.03, batch 100, 15% of train held out as "valid": the MNIST IDX files of
``data_dir`` when given, else the synthetic stand-in (2000 / 500) drawn as
the JAX package draws it.  The products are ``torch.matmul`` (cuBLAS on the
card): the JAX package's are plain ``jnp`` products, no Pallas kernel.
"""

from znicz_tpu_torch.core import device as device_lib
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.loader import datasets
from znicz_tpu_torch.models import effective_config, merge_workflow_kwargs
from znicz_tpu_torch.workflow.standard import StandardWorkflow

_GD = {"learning_rate": 0.03, "gradient_moment": 0.9, "weights_decay": 0.0005}

DEFAULTS = {
    "loader": {
        "data_dir": None,  # real IDX dir; None -> deterministic synthetic
        "minibatch_size": 100,
        "validation_ratio": 0.15,
        "n_train": 2000,  # synthetic stand-in sizes
        "n_test": 500,
    },
    "layers": [
        {"type": "all2all_tanh", "->": {"output_sample_shape": 100}, "<-": _GD},
        {"type": "softmax", "->": {"output_sample_shape": 10}, "<-": _GD},
    ],
    "decision": {"max_epochs": 10, "fail_iterations": 20},
}
root.mnist.update(DEFAULTS)


def build_workflow(**overrides) -> StandardWorkflow:
    """The MNIST MLP workflow; ``device=`` picks the device (default: the
    card, raising without one), other overrides go to StandardWorkflow."""
    # pick the device first: without a card this raises before any data is made
    overrides["device"] = device_lib.resolve(overrides.get("device"))
    cfg = effective_config(root.mnist, DEFAULTS)
    lcfg = cfg.loader
    loader = datasets.mnist(
        lcfg.get("data_dir") or root.common.get("data_dir"),
        minibatch_size=lcfg.get("minibatch_size", 100),
        validation_ratio=lcfg.get("validation_ratio", 0.0),
        n_train=lcfg.get("n_train", 2000),
        n_test=lcfg.get("n_test", 500),
    )
    kwargs = merge_workflow_kwargs(
        {"decision_config": cfg.decision.to_dict(), "name": "MnistWorkflow"},
        overrides,
    )
    return StandardWorkflow(loader, cfg.get("layers"), **kwargs)
