"""AlexNet-class ImageNet workflow (port of ``znicz_tpu/models/alexnet.py``).

Canonical single-tower AlexNet geometry (227 input, 5 conv + 3 FC, NHWC)
with the JAX package's DEFAULTS: on the packed images of ``data_dir``
(``loader/imagenet.py``: random crops and flips cut on the host by the
native gather, a raw image tree packed on first use, the head sized to the
dataset's classes) when given, else on the synthetic ImageNet stand-in.
Either way u8 images cross to the device and are converted there.  On the
card both ``norm`` layers run the hand-written LRN kernel pair
(``ops/kernels/lrn.py``).
"""

from znicz_tpu_torch.core import device as device_lib
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.loader import datasets
from znicz_tpu_torch.loader.imagenet import ImageNetLoader
from znicz_tpu_torch.models import effective_config, merge_workflow_kwargs
from znicz_tpu_torch.workflow.standard import StandardWorkflow

_GD = {
    "learning_rate": 0.01,
    "gradient_moment": 0.9,
    "weights_decay": 0.0005,
    "learning_rate_bias": 0.02,
    "weights_decay_bias": 0.0,
}


def _conv(n, k, *, sliding=(1, 1), padding=(0, 0, 0, 0)):
    return {
        "type": "conv_relu",
        "->": {
            "n_kernels": n, "kx": k, "ky": k, "sliding": sliding,
            "padding": padding, "weights_filling": "gaussian",
            "weights_stddev": 0.01,
        },
        "<-": _GD,
    }


DEFAULTS = {
    "loader": {
        "data_dir": None,  # packed (or raw) image tree; synthetic when None
        "pack_size": 256,
        "image_size": 227,
        "n_classes": 1000,
        "minibatch_size": 128,
        "n_train": 512,  # synthetic stand-in sizes
        "n_valid": 128,
    },
    "layers": [
        _conv(96, 11, sliding=(4, 4)),
        {"type": "norm", "->": {"n": 5, "alpha": 1e-4, "beta": 0.75, "k": 2.0}},
        {"type": "max_pooling", "->": {"kx": 3, "ky": 3, "sliding": (2, 2)}},
        _conv(256, 5, padding=(2, 2, 2, 2)),
        {"type": "norm", "->": {"n": 5, "alpha": 1e-4, "beta": 0.75, "k": 2.0}},
        {"type": "max_pooling", "->": {"kx": 3, "ky": 3, "sliding": (2, 2)}},
        _conv(384, 3, padding=(1, 1, 1, 1)),
        _conv(384, 3, padding=(1, 1, 1, 1)),
        _conv(256, 3, padding=(1, 1, 1, 1)),
        {"type": "max_pooling", "->": {"kx": 3, "ky": 3, "sliding": (2, 2)}},
        {
            "type": "all2all_relu",
            "->": {
                "output_sample_shape": 4096,
                "weights_filling": "gaussian", "weights_stddev": 0.005,
            },
            "<-": _GD,
        },
        {"type": "dropout", "->": {"dropout_ratio": 0.5}},
        {
            "type": "all2all_relu",
            "->": {
                "output_sample_shape": 4096,
                "weights_filling": "gaussian", "weights_stddev": 0.005,
            },
            "<-": _GD,
        },
        {"type": "dropout", "->": {"dropout_ratio": 0.5}},
        {
            "type": "softmax",
            "->": {
                "output_sample_shape": 1000,
                "weights_filling": "gaussian", "weights_stddev": 0.01,
            },
            "<-": _GD,
        },
    ],
    "decision": {"max_epochs": 90, "fail_iterations": 30},
    "lr_policy": {"name": "step", "step_size": 100000, "gamma": 0.1},
    # bf16 activations halve the bytes moved; params stay f32 masters
    "compute_dtype": "bfloat16",
}
root.alexnet.update(DEFAULTS)


def build_workflow(**overrides) -> StandardWorkflow:
    """The AlexNet workflow; ``device=`` picks the device (default: the
    card, raising without one), other overrides go to StandardWorkflow."""
    # pick the device first: without a card this raises before any data is made
    overrides["device"] = device_lib.resolve(overrides.get("device"))
    cfg = effective_config(root.alexnet, DEFAULTS)
    lcfg = cfg.loader
    layers = cfg.get("layers")
    data_dir = lcfg.get("data_dir") or root.common.get("data_dir")
    if data_dir:
        loader = ImageNetLoader(
            data_dir,
            crop_size=lcfg.get("image_size", 227),
            pack_size=lcfg.get("pack_size", 256),
            minibatch_size=lcfg.get("minibatch_size", 128),
        )
        # the classifier head matches the dataset's class count
        layers[-1]["->"]["output_sample_shape"] = loader.n_classes()
    else:
        loader = datasets.imagenet_synthetic(
            image_size=lcfg.get("image_size", 227),
            n_classes=lcfg.get("n_classes", 1000),
            n_train=lcfg.get("n_train", 512),
            n_valid=lcfg.get("n_valid", 128),
            minibatch_size=lcfg.get("minibatch_size", 128),
        )
    kwargs = merge_workflow_kwargs(
        {
            "decision_config": cfg.decision.to_dict(),
            "lr_policy": cfg.get("lr_policy"),
            "compute_dtype": cfg.get("compute_dtype"),
            "name": "AlexNetWorkflow",
        },
        overrides,
    )
    return StandardWorkflow(loader, layers, **kwargs)


def run(load, main):
    load(build_workflow)
    main()
