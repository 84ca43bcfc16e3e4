"""CIFAR-10 convolutional workflow (port of ``znicz_tpu/models/cifar.py``;
BASELINE.json configs[1]).

conv_relu 32 5x5 pad 2 -> max-pool 3/2 -> LRN n 5 -> conv_relu 64 5x5 pad 2
-> avg-pool 3/2 -> all2all_relu 64 -> softmax 10, f32, batch 100, under the
``inv`` lr policy (gamma 1e-4, power 0.75): the python-pickle batches of
``data_dir`` when given, else the synthetic stand-in (2000 / 500) drawn as
the JAX package draws it.  On the card the ``norm`` layer runs the
hand-written LRN kernel pair (``ops/kernels/lrn.py``) at ``[100, 15, 15,
32]``; convolutions and pools are cuDNN, as the JAX package left them to XLA.
"""

from znicz_tpu_torch.core import device as device_lib
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.loader import datasets
from znicz_tpu_torch.models import effective_config, merge_workflow_kwargs
from znicz_tpu_torch.workflow.standard import StandardWorkflow

_GD = {"learning_rate": 0.01, "gradient_moment": 0.9, "weights_decay": 0.0005}


def _conv(n):
    return {
        "type": "conv_relu",
        "->": {
            "n_kernels": n, "kx": 5, "ky": 5, "padding": (2, 2, 2, 2),
            "weights_filling": "gaussian", "weights_stddev": 0.01,
        },
        "<-": _GD,
    }


DEFAULTS = {
    "loader": {
        "data_dir": None,  # real cifar-10-batches-py dir; None -> synthetic
        "minibatch_size": 100,
        "n_train": 2000,
        "n_test": 500,
    },
    "layers": [
        _conv(32),
        {"type": "max_pooling", "->": {"kx": 3, "ky": 3, "sliding": (2, 2)}},
        {"type": "norm", "->": {"n": 5}},
        _conv(64),
        {"type": "avg_pooling", "->": {"kx": 3, "ky": 3, "sliding": (2, 2)}},
        {"type": "all2all_relu", "->": {"output_sample_shape": 64}, "<-": _GD},
        {"type": "softmax", "->": {"output_sample_shape": 10}, "<-": _GD},
    ],
    "decision": {"max_epochs": 20, "fail_iterations": 20},
    "lr_policy": {"name": "inv", "gamma": 0.0001, "power": 0.75},
}
root.cifar.update(DEFAULTS)


def build_workflow(**overrides) -> StandardWorkflow:
    """The CIFAR-10 workflow; ``device=`` picks the device (default: the
    card, raising without one), other overrides go to StandardWorkflow."""
    overrides["device"] = device_lib.resolve(overrides.get("device"))
    cfg = effective_config(root.cifar, DEFAULTS)
    lcfg = cfg.loader
    loader = datasets.cifar10(
        lcfg.get("data_dir") or root.common.get("data_dir"),
        minibatch_size=lcfg.get("minibatch_size", 100),
        n_train=lcfg.get("n_train", 2000),
        n_test=lcfg.get("n_test", 500),
    )
    kwargs = merge_workflow_kwargs(
        {
            "decision_config": cfg.decision.to_dict(),
            "lr_policy": cfg.get("lr_policy"),
            "name": "CifarWorkflow",
        },
        overrides,
    )
    return StandardWorkflow(loader, cfg.get("layers"), **kwargs)


def run(load, main):
    load(build_workflow)
    main()
