"""MNIST Bernoulli RBM with CD-1 (port of ``znicz_tpu/models/mnist_rbm.py``;
BASELINE.json configs[2], RBM path).

784 visible and 128 hidden units, CD-1, batch 100, lr 0.1, on "linear"
normalized input mapped onto [0, 1]: the MNIST IDX files of ``data_dir``
when given, else the synthetic stand-in drawn as the JAX package draws it.
"""

from znicz_tpu_torch.core import device as device_lib
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.loader import datasets
from znicz_tpu_torch.models import (
    effective_config,
    merge_workflow_kwargs,
    translate_unsupervised_overrides,
)
from znicz_tpu_torch.workflow.unsupervised import RBMWorkflow

DEFAULTS = {
    "loader": {
        "data_dir": None,
        "minibatch_size": 100,
        "n_train": 1000,
        "n_test": 200,
    },
    "n_hidden": 128,
    "learning_rate": 0.1,
    "cd_k": 1,
    "max_epochs": 20,
}
root.mnist_rbm.update(DEFAULTS)


def build_workflow(device=None, **overrides) -> RBMWorkflow:
    """The RBM workflow; ``device`` defaults to the card (raising without
    one), other overrides go to :class:`RBMWorkflow`."""
    # pick the device first: without a card this raises before any data is made
    device = device_lib.resolve(device)
    cfg = effective_config(root.mnist_rbm, DEFAULTS)
    lcfg = cfg.loader
    loader = datasets.mnist(
        lcfg.get("data_dir") or root.common.get("data_dir"),
        minibatch_size=lcfg.get("minibatch_size", 100),
        n_train=lcfg.get("n_train", 1000),
        n_test=lcfg.get("n_test", 200),
        # Bernoulli units want [0, 1] inputs
        normalization="linear",
    )
    for split, arr in loader.data.items():  # [-1, 1] -> [0, 1]
        loader.data[split] = (arr + 1.0) / 2.0
    kwargs = merge_workflow_kwargs(
        {
            "n_hidden": cfg.get("n_hidden", 128),
            "learning_rate": cfg.get("learning_rate", 0.1),
            "cd_k": cfg.get("cd_k", 1),
            "max_epochs": cfg.get("max_epochs", 20),
            "name": "MnistRBMWorkflow",
        },
        overrides,
    )
    kwargs = translate_unsupervised_overrides(kwargs, "max_epochs")
    return RBMWorkflow(loader, device=device, **kwargs)


def run(load, main):
    load(build_workflow)
    main()
