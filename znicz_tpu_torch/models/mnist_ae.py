"""MNIST convolutional autoencoder (port of ``znicz_tpu/models/mnist_ae.py``;
the autoencoder half of BASELINE.json configs[2]).

conv_tanh 12 kernels of 10x10 at stride 3 (28x28x1 -> 7x7x12) -> deconv
back to 28x28x1, trained with MSE against the input, batch 100: the MNIST
IDX files of ``data_dir`` when given, else the synthetic stand-in (1000 /
200) drawn as the JAX package draws it.  The deconv is cuDNN's transposed
convolution (``ops/deconv.py``), as the JAX package left it to XLA.
"""

from znicz_tpu_torch.core import device as device_lib
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.loader import datasets
from znicz_tpu_torch.models import effective_config, merge_workflow_kwargs
from znicz_tpu_torch.workflow.standard import StandardWorkflow

_GD = {"learning_rate": 0.01, "gradient_moment": 0.9}

DEFAULTS = {
    "loader": {
        "data_dir": None,
        "minibatch_size": 100,
        "n_train": 1000,
        "n_test": 200,
    },
    "layers": [
        {
            "type": "conv_tanh",
            "->": {
                "n_kernels": 12, "kx": 10, "ky": 10, "sliding": (3, 3),
                "weights_filling": "gaussian", "weights_stddev": 0.05,
            },
            "<-": _GD,
        },
        {
            "type": "deconv",
            "->": {
                "n_channels": 1, "kx": 10, "ky": 10, "sliding": (3, 3),
                "weights_filling": "gaussian", "weights_stddev": 0.05,
            },
            "<-": _GD,
        },
    ],
    "decision": {"max_epochs": 20, "fail_iterations": 20},
}
root.mnist_ae.update(DEFAULTS)


def build_workflow(**overrides) -> StandardWorkflow:
    """The MNIST autoencoder workflow; ``device=`` picks the device (default:
    the card, raising without one), other overrides go to StandardWorkflow."""
    overrides["device"] = device_lib.resolve(overrides.get("device"))
    cfg = effective_config(root.mnist_ae, DEFAULTS)
    lcfg = cfg.loader
    loader = datasets.mnist(
        lcfg.get("data_dir") or root.common.get("data_dir"),
        minibatch_size=lcfg.get("minibatch_size", 100),
        n_train=lcfg.get("n_train", 1000),
        n_test=lcfg.get("n_test", 200),
        flat=False,  # NHWC for the conv
    )
    kwargs = merge_workflow_kwargs(
        {
            "decision_config": cfg.decision.to_dict(),
            "loss_function": "mse",
            "target": "input",
            "name": "MnistAEWorkflow",
        },
        overrides,
    )
    return StandardWorkflow(loader, cfg.get("layers"), **kwargs)
